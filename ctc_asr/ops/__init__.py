"""Numeric ops: CTC loss, decoders, beam search, n-gram LM, GPU kernels.

This package replaces the reference's native-code dependencies
(SURVEY.md §2b): ``tf.nn.ctc_loss`` -> ``ctc_ref`` (with the Triton
α/β kernel of ``ctc_triton`` on CUDA); ``tf.nn.ctc_greedy_decoder`` /
``ctc_beam_search_decoder`` -> ``greedy`` / ``beam``; ``tf.signal`` DSP ->
``features.py``; KenLM-style LM -> ``lm``.
"""

from .ctc_ref import ctc_loss_ref, ctc_loss

__all__ = ["ctc_loss_ref", "ctc_loss"]
