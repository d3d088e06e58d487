"""Evaluation driver: checkpoint -> dev/test decode -> corpus WER/CER.

Capability parity with the reference's ``asr/evaluate.py`` (SURVEY.md
§2a/§3.2: restore checkpoint, run dev/test set, decode, mean WER/edit
distance, log sample transcripts) — with decoding ON DEVICE (greedy or
vectorized beam search) instead of the reference's per-utterance CPU
beam decoder (§3.2 hot loop).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config
from .data import DataLoader, read_manifest
from .metrics import ErrorRateAccumulator
from .text import decode_ids
from .train import make_eval_step


def make_decoder(cfg: Config):
    """Returns jitted ``(logits, logit_lens) -> (ids, lens)`` per config
    (greedy or beam, with optional LM fusion)."""
    if cfg.decode.method == "greedy":
        from .ops.greedy import greedy_decode

        def decode(logits, logit_lens):
            return greedy_decode(logits, logit_lens)
        return jax.jit(decode)
    if cfg.decode.method == "beam":
        from .ops import beam as beam_mod
        lm = None
        if cfg.decode.lm_path:
            from .ops import lm as lm_mod
            lm = lm_mod.load_lm(cfg.decode.lm_path)
        return beam_mod.make_beam_decoder(
            beam_width=cfg.decode.beam_width, lm=lm,
            lm_weight=cfg.decode.lm_weight,
            word_bonus=cfg.decode.word_bonus,
            max_decode_len=beam_mod.derive_max_decode_len(
                cfg.decode, cfg.data))
    raise ValueError(f"unknown decode method {cfg.decode.method!r}")


def make_nbest_decoder(cfg: Config):
    """jitted ``(logits, lens) -> (ids [B,K,U], lens [B,K], scores)``
    plus the loaded word LM, for host-side rescoring."""
    from .ops import beam as beam_mod
    from .ops import lm as lm_mod
    char_lm = lm_mod.load_lm(cfg.decode.lm_path) if cfg.decode.lm_path \
        else None
    word_lm = lm_mod.load_word_lm(cfg.decode.word_lm_path)
    if char_lm is not None:
        table = jnp.asarray(char_lm["table"])
        init_ctx = lm_mod.initial_context(int(char_lm["order"]))
        lm_weight = cfg.decode.lm_weight
        word_bonus = cfg.decode.word_bonus
    else:
        table, init_ctx, lm_weight, word_bonus = None, 0, 0.0, 0.0

    K = min(cfg.decode.nbest, cfg.decode.beam_width)
    max_dec = beam_mod.derive_max_decode_len(cfg.decode, cfg.data)

    @jax.jit
    def decode(logits, logit_lens):
        ids, lens, scores = beam_mod.beam_search_decode(
            logits, logit_lens, beam_width=cfg.decode.beam_width,
            lm_table=table, lm_weight=lm_weight,
            word_bonus=word_bonus, init_ctx=init_ctx,
            return_nbest=True, max_decode_len=max_dec)
        return ids[:, :K], lens[:, :K], scores[:, :K]

    # text -> word-LM log-prob, lives across batches. Bounded (ADVICE
    # r2): one entry per unique hypothesis string would otherwise grow
    # without limit over a large corpus; cross-batch hits come mostly
    # from recent/short hypotheses, so a flush loses little.
    score_cache: dict = {}
    _SCORE_CACHE_MAX = 200_000

    def pick_best(ids, lens, scores):
        """Host: rescore each utterance's N-best, return (ids, lens).

        Batched + memoized (ops/lm.rescore_nbest_batch): duplicate
        hypotheses — within an N-best list and across the corpus — are
        scored once, and the word-LM stats are precomputed, so this
        stays within ~2x of the acoustic-beam RTF instead of the
        round-1 10-30x cliff."""
        if len(score_cache) > _SCORE_CACHE_MAX:
            score_cache.clear()
        ids, lens, scores = (np.asarray(ids), np.asarray(lens),
                             np.asarray(scores))
        B, K = ids.shape[0], ids.shape[1]
        texts = [[decode_ids(ids[b, k, :lens[b, k]]) for k in range(K)]
                 for b in range(B)]
        best = lm_mod.rescore_nbest_batch(
            texts, scores, word_lm, alpha=cfg.decode.rescore_alpha,
            beta=cfg.decode.rescore_beta, cache=score_cache)
        bidx = np.arange(B)
        return ids[bidx, best], lens[bidx, best]

    return decode, pick_best


def evaluate(cfg: Config, params, loader: DataLoader | None = None,
             max_batches: int | None = None, log_samples: int = 3) -> dict:
    """Decode the eval manifest; returns corpus metrics summary."""
    if loader is None:
        manifest = read_manifest(cfg.data.eval_manifest)
        loader = DataLoader(manifest, cfg.data, cfg.features,
                            shard_idx=jax.process_index(),
                            num_shards=jax.process_count(),
                            drop_last=False)
    put = None
    if cfg.mesh.seq_axis > 1 and jax.process_count() == 1:
        # sequence-parallel eval (config-driven, like train()): encoder
        # activations time-shard over a ('seq',) mesh of local devices;
        # decode runs on the replicated gathered logits
        import functools as _ft
        import numpy as _np
        from jax.sharding import Mesh
        from .parallel import seqpar
        devs = jax.devices()
        if len(devs) < cfg.mesh.seq_axis:
            raise ValueError(
                f"mesh.seq_axis={cfg.mesh.seq_axis} needs that many "
                f"local devices, have {len(devs)}")
        sp_mesh = Mesh(_np.array(devs[:cfg.mesh.seq_axis]), ("seq",))
        eval_step = seqpar.make_sp_eval_step(cfg, sp_mesh)
        put = _ft.partial(seqpar.sp_batch_put, sp_mesh)
    else:
        eval_step = make_eval_step(cfg)
    rescorer = None
    if cfg.decode.word_lm_path and cfg.decode.method == "beam":
        nbest_decode, rescorer = make_nbest_decoder(cfg)
        decoder = None
    else:
        decoder = make_decoder(cfg)
    acc = ErrorRateAccumulator()
    total_audio = 0.0
    import time
    t0 = time.perf_counter()
    t_prev = t0
    steady_wall, steady_audio = 0.0, 0.0
    seen_buckets: set = set()
    shown = 0
    from .train import device_batches
    src = loader.iter_epoch(0)
    if max_batches is not None:
        # slice BEFORE the device prefetch so nothing beyond the cap is
        # decoded or uploaded
        import itertools
        src = itertools.islice(src, max_batches)
    for batch, dev in device_batches(src, with_labels=False, put=put):
        d_samples, d_slens = dev
        logits, logit_lens = eval_step(params, d_samples, d_slens)
        if rescorer is not None:
            nb_ids, nb_lens, nb_scores = nbest_decode(logits, logit_lens)
            ids, lens = rescorer(nb_ids, nb_lens, nb_scores)
        else:
            ids, lens = decoder(logits, logit_lens)
        ids, lens = np.asarray(ids), np.asarray(lens)
        for i in range(batch.valid):
            hyp = decode_ids(ids[i, :lens[i]])
            ref = batch.transcripts[i]
            acc.add(ref, hyp)
            if shown < log_samples:
                print(f"[eval] ref: {ref!r}\n[eval] hyp: {hyp!r}",
                      flush=True)
                shown += 1
        total_audio += batch.audio_seconds
        # Steady-state accounting: the FIRST batch of EACH length
        # bucket pays that bucket shape's jit trace+compile (one encoder
        # + one decoder program per bucket), so it stays out of the
        # steady window. The per-batch np.asarray(ids) fetch above waits
        # for the device, so per-batch wall deltas are meaningful.
        now = time.perf_counter()
        if batch.bucket_id in seen_buckets:
            steady_wall += now - t_prev
            steady_audio += batch.audio_seconds
        else:
            seen_buckets.add(batch.bucket_id)
        t_prev = now
    wall = time.perf_counter() - t0
    if jax.process_count() > 1:
        # multi-process: each process decoded its own loader shard.
        # Allgather the per-utterance (we, wc, ce, cc) records — tiny
        # int tuples — and rebuild ONE corpus accumulator, so every
        # derived artifact (corpus WER/CER, the bootstrap CI, and
        # --dump-utts' per_utt sidecar) describes the same full corpus.
        # Shards may be unequal (drop_last=False): pad to the gathered
        # max count and mask. per_utt ordering is process-major, which
        # is the manifest's strided-shard order re-interleaved — stable
        # for a fixed process count.
        from jax.experimental import multihost_utils
        rec = np.asarray(acc.utt_records, np.int64).reshape(-1, 4)
        n_all = np.asarray(multihost_utils.process_allgather(
            np.array([rec.shape[0]], np.int64))).reshape(-1)
        padded = np.zeros((max(1, int(n_all.max())), 4), np.int64)
        padded[: rec.shape[0]] = rec
        gathered = np.asarray(
            multihost_utils.process_allgather(padded))
        merged = ErrorRateAccumulator()
        for p in range(gathered.shape[0]):
            for we, wc, ce, cc in gathered[p, : int(n_all[p])]:
                merged.add_record(int(we), int(wc), int(ce), int(cc))
        acc = merged
    out = acc.summary()
    # bootstrap 95% CIs on corpus WER/CER + the raw per-utterance
    # (we, wc, ce, cc) records, so callers can run paired bootstrap
    # comparisons between systems evaluated on the same manifest
    # (metrics.paired_bootstrap; VERDICT r3 next #1)
    out.update(acc.bootstrap_ci())
    out["per_utt"] = list(acc.utt_records)
    # RTF: processing time per second of audio (north-star decode metric,
    # BASELINE.json:2). <1 means faster than real time. Steady-state =
    # every batch except each bucket's first (which pays that shape's
    # jit compile — see the loop comment); rtf_incl_compile has the
    # raw number.
    if steady_audio > 0:
        out["rtf"] = steady_wall / steady_audio
    else:
        out["rtf"] = wall / max(total_audio, 1e-9)
    out["rtf_incl_compile"] = wall / max(total_audio, 1e-9)
    out["audio_seconds"] = total_audio
    out["wall_seconds"] = wall
    return out
