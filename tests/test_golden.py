"""Golden parity (SURVEY.md §4.4): frozen tiny-model forward / loss /
decode outputs catch silent numeric regressions.

The golden file is generated once (CPU, f32) and committed; regenerate
deliberately with: python tests/test_golden.py --regen
"""

import os
import sys

import numpy as np

import jax
import jax.numpy as jnp

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "tiny_model.npz")


def _build():
    from ctc_asr.config import Config, FeatureConfig, ModelConfig
    from ctc_asr.models import apply_encoder, init_params
    from ctc_asr.ops.ctc_ref import ctc_loss_ref
    from ctc_asr.ops.greedy import greedy_decode
    from ctc_asr import features as feat_mod

    cfg = Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=13, n_mels=26),
        model=ModelConfig(frontend="dense", dense_layers=1,
                          dense_units=32, rnn_layers=1, rnn_units=32,
                          dropout=0.0, compute_dtype="float32"),
    )
    rng = np.random.default_rng(12345)
    B, sec = 2, 0.6
    samples = jnp.asarray(
        (rng.standard_normal((B, int(sec * 16000))) * 0.2)
        .astype(np.float32))
    slens = jnp.asarray([samples.shape[1], samples.shape[1] // 2],
                        jnp.int32)
    labels = jnp.asarray(rng.integers(0, 28, (B, 6)).astype(np.int32))
    llens = jnp.asarray([6, 4], jnp.int32)

    feats, flens = feat_mod.extract_features(samples, slens, cfg.features)
    params = init_params(jax.random.PRNGKey(7), cfg.model,
                         cfg.features.feature_dim)
    logits, logit_lens = apply_encoder(params, feats, flens, cfg.model)
    nll = ctc_loss_ref(logits, logit_lens, labels, llens)
    ids, dlens = greedy_decode(logits, logit_lens)
    return {
        "feats": np.asarray(feats), "flens": np.asarray(flens),
        "logits": np.asarray(logits), "logit_lens": np.asarray(logit_lens),
        "nll": np.asarray(nll), "ids": np.asarray(ids),
        "dlens": np.asarray(dlens),
    }


def test_golden_outputs():
    got = _build()
    assert os.path.exists(GOLDEN_PATH), (
        "golden file missing; run: python tests/test_golden.py --regen")
    with np.load(GOLDEN_PATH) as z:
        for k in got:
            want = z[k]
            if got[k].dtype.kind == "f":
                np.testing.assert_allclose(
                    got[k], want, rtol=2e-4, atol=2e-4, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want, err_msg=k)


if __name__ == "__main__":
    if "--regen" in sys.argv:
        os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
        np.savez_compressed(GOLDEN_PATH, **_build())
        print(f"wrote {GOLDEN_PATH}")
