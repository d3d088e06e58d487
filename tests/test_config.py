import pytest

from ctc_asr import config as cfg_mod


def test_defaults_roundtrip_json():
    cfg = cfg_mod.Config()
    s = cfg_mod.to_json(cfg)
    cfg2 = cfg_mod.from_json(s)
    assert cfg == cfg2


def test_overrides():
    cfg = cfg_mod.Config()
    out = cfg_mod.apply_overrides(cfg, {
        "train.learning_rate": "3e-4",
        "model.rnn_layers": "5",
        "model.bidirectional": "true",
        "features.feature_type": "mfcc",
    })
    assert out.train.learning_rate == 3e-4
    assert out.model.rnn_layers == 5
    assert out.model.bidirectional is True
    assert out.features.feature_type == "mfcc"
    # original untouched (frozen)
    assert cfg.model.rnn_layers == 2


def test_override_unknown_key():
    with pytest.raises(KeyError):
        cfg_mod.apply_overrides(cfg_mod.Config(), {"model.bogus": 1})


def test_parse_cli():
    ov = cfg_mod.parse_cli_overrides(["--train.total_steps=10",
                                      "--decode.method=beam"])
    assert ov == {"train.total_steps": "10", "decode.method": "beam"}
    with pytest.raises(ValueError):
        cfg_mod.parse_cli_overrides(["train.total_steps"])


def test_presets_cover_judge_ladder():
    for name in ("pr1_mfcc_uni", "conv_bilstm3", "deepspeech_beam",
                 "lm_fusion_960h", "multihost_dp"):
        c = cfg_mod.preset(name)
        assert c.model.num_classes == 29
    assert cfg_mod.preset("deepspeech_beam").decode.beam_width == 64
    assert cfg_mod.preset("conv_bilstm3").model.bidirectional
    with pytest.raises(KeyError):
        cfg_mod.preset("nope")


def test_feature_config_derived():
    f = cfg_mod.FeatureConfig()
    assert f.win_length == 400
    assert f.hop_length == 160
    assert f.feature_dim == f.n_mels
    assert cfg_mod.FeatureConfig(feature_type="mfcc").feature_dim == 13
