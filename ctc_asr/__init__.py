"""ctc_asr — a CTC speech-recognition framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
``mdangschat/ctc-asr`` (a TF-1.x single-GPU DeepSpeech-style CTC trainer;
see SURVEY.md §0-§2): wav audio -> STFT/mel/MFCC features -> conv+(bi)RNN
acoustic encoder -> CTC loss -> greedy/beam decode (+ n-gram LM fusion)
-> WER evaluation; plus train/eval/transcribe CLIs, checkpointing,
dataset generation and multi-device data/model parallelism via
``jax.sharding`` meshes (new capability mandated by BASELINE.json:5).

Layout
------
- ``config``      frozen dataclass config tree (replaces asr/params.py FLAGS)
- ``text``        charset + encode/decode (replaces asr/labels.py)
- ``metrics``     WER / Levenshtein / throughput meters (asr/metrics)
- ``audio``       wav I/O (replaces scipy/wave usage in asr/load_sample.py)
- ``features``    STFT / log-mel / MFCC, matmul-formulated
- ``data``        manifests + bucketed sharded loader (asr/input_functions.py)
- ``models``      functional conv/(bi)RNN encoders (asr/model.py)
- ``ops``         CTC loss (pure-JAX ref + Pallas), beam search, n-gram LM
- ``parallel``    mesh/sharding/pjit utilities (new vs reference)
- ``train/evaluate/transcribe``  drivers (asr/train.py, evaluate.py, predict.py)
"""

__version__ = "0.1.0"
