"""liquidSVM-style command line: the staged cycle as separate processes
(the JAX package's ``cli.py``).

The package ships ``svm-train`` / ``svm-select`` / ``svm-test`` binaries
that communicate through files, so selection can be re-run (new NPL
constraint, ROC front, plain argmin) without repeating the expensive
training sweep.  This is the same cycle over the staged session API:

    python -m repro_torch.cli train  --data xtr.npy --labels ytr.npy \\
        --model-dir run1 --scenario binary -S FOLDS=3 -S VORONOI=voronoi
    python -m repro_torch.cli select --model-dir run1 --rule npl -S NPL_CONSTRAINT=0.01
    python -m repro_torch.cli select --model-dir run1 --rule roc      # no retrain
    python -m repro_torch.cli test   --data xte.npy --labels yte.npy --model-dir run1
    python -m repro_torch.cli serve  --data xq.npy --model-dir run1 \\
        -S DEADLINE_MS=5 --out pred.npy     # async engine from bank/ alone

Token corpora get one extra stage in front — the frozen-backbone
embedding pipeline (``repro_torch.embed``):

    python -m repro_torch.cli embed  --tokens tok.npy --model-dir run1 \\
        -S EMBED_ARCH=stablelm-1.6b:smoke -S EMBED_POOL=mean
    python -m repro_torch.cli train  --data run1/embed --labels y.npy ...
    python -m repro_torch.cli serve  --tokens tokq.npy --model-dir run1 ...

Artifacts under ``--model-dir`` (all ``repro_torch.train.checkpoint`` step
dirs, in the JAX package's format, except ``embed/``, which is an
``EmbedCache`` shard directory):

    embed/   EmbedCache    — fingerprinted npz embedding shards + meta.json
             (``--data <model-dir>/embed`` streams them; ``serve --tokens``
             rebuilds the recorded extractor for in-process embedding)
    train/   TrainResult  — cell models + retained CV surface
    select/  SelectResult — final models, rule extras, stats
    bank/    ModelBank    — compacted serving bank; a predict server
             cold-starts from it alone:
             ``SVMEngine(ModelBank.load(f"{model_dir}/bank"))``

Every stage runs on the current CUDA card unless ``--device cpu`` asks for
the plain PyTorch path.  ``--data`` accepts an ``.npy`` file (opened as a memmap — training and
testing stream, the array is never resident), a comma-separated list of
``.npz`` shards, or a completed ``embed/`` artifact directory; ``--labels``
is an ``.npy`` vector.  ``-S KEY=VALUE`` sets any string config key
(``--help-keys`` lists them).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

import numpy as np

# scenario aliases: front-end names -> trainer scenarios (+ default rule)
_SCENARIOS = {
    "binary": "binary", "ova": "ova", "ava": "ava", "mc": "ova",
    "weighted": "weighted", "roc": "weighted", "npl": "npsvm",
    "npsvm": "npsvm", "quantile": "quantile", "qt": "quantile",
    "expectile": "expectile", "ex": "expectile", "ls": "ls",
}
_SCENARIO_RULES = {"roc": "roc", "npl": "npl", "npsvm": "npl"}


def _load_data(spec: str):
    """'.npy' path (memmap-streamed), comma-separated '.npz' shards, or a
    completed ``embed/`` cache directory (replayed shard-by-shard)."""
    from repro_torch.pipeline.dataset import as_source
    if os.path.isdir(spec):
        return _open_embed_artifact(spec)
    if "," in spec:
        return as_source([p for p in spec.split(",") if p])
    return as_source(spec)


def _open_embed_artifact(path: str):
    """A directory as ``--data``: it must be a COMPLETE embed cache."""
    from repro_torch.embed.source import EmbedCache, EmbedCacheError
    from repro_torch.pipeline.dataset import ShardedNpzSource
    try:
        meta = EmbedCache.open(path)
    except EmbedCacheError as e:
        _fail(f"{e} — run `python -m repro_torch.cli embed` to produce one")
    cache = EmbedCache(path, meta["fingerprint"], n_rows=meta["n_rows"],
                       dim=meta["dim"], block=meta["block"],
                       seq_len=meta["seq_len"])
    if not cache.complete():
        _fail(f"{path}: incomplete 'embed/' artifact (missing shards) — "
              f"re-run `python -m repro_torch.cli embed`")
    return ShardedNpzSource(cache.shard_paths())


def _parse_sets(pairs: Optional[List[str]]) -> dict:
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"-S expects KEY=VALUE, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def _emit(payload: dict) -> None:
    json.dump(payload, sys.stdout, indent=2, default=float)
    sys.stdout.write("\n")


def _setup_obs(pairs: dict) -> dict:
    """Split TRACE/METRICS_OUT/PROFILE_DIR off a ``-S`` key dict and apply
    them to the process-global ``repro_torch.obs`` instruments; returns the
    remaining pairs for the stage's own key handling."""
    from repro_torch.api.config import split_obs_keys
    rest, obs_kw = split_obs_keys(pairs)
    if obs_kw:
        from repro_torch import obs
        obs.configure(**obs_kw)
    return rest


def _finish_obs(payload: dict) -> dict:
    """Fold observability output into a stage's JSON payload.

    Always surfaces restore fallbacks and corrupt-wave re-solves (silent
    degradation an operator must see); writes the
    metrics JSONL when ``METRICS_OUT`` was configured and the per-site
    span summary when ``TRACE`` was on.
    """
    from repro_torch import obs
    from repro_torch.train.checkpoint import fallback_log
    fl = fallback_log()
    payload["checkpoint_fallbacks"] = len(fl)
    if fl:
        payload["checkpoint_fallback_steps"] = [list(x) for x in fl]
    summary = obs.metrics.summary()
    corrupt = summary.get("train.corrupt_waves", 0)
    if corrupt:
        payload["corrupt_waves_resolved"] = int(corrupt)
    out = obs.flush_metrics(extra={"stage": payload.get("stage")})
    if out:
        payload["metrics_out"] = out
    if obs.tracer.enabled:
        payload["trace"] = obs.tracer.summary()
    tout = obs.flush_trace()
    if tout:
        payload["trace_out"] = tout
    return payload


def _fail(msg: str) -> "SystemExit":
    """Actionable operator error -> stderr + exit code 2 (not a traceback)."""
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(2)


def _load_artifact(model_dir: str, name: str, loader, produced_by: str):
    """Load a staged artifact dir with actionable failure messages.

    Missing, incomplete (no checkpoint step survived) and corrupt
    (checksum/manifest verification failed) dirs all exit with code 2 and
    say which stage to (re-)run, instead of surfacing a raw traceback.
    """
    from repro_torch.train.checkpoint import CheckpointCorruptError

    path = os.path.join(model_dir, name)
    hint = f"run `python -m repro_torch.cli {produced_by}` first"
    if not os.path.isdir(path):
        _fail(f"{path}: missing '{name}/' artifact — {hint}")
    try:
        return loader(path)
    except FileNotFoundError as e:
        _fail(f"{path}: incomplete '{name}/' artifact ({e}) — {hint}")
    except CheckpointCorruptError as e:
        _fail(f"{path}: corrupt '{name}/' artifact ({e}) — re-{hint}")
    except ValueError as e:
        _fail(f"{path}: not a valid '{name}/' artifact ({e}) — {hint}")


# ------------------------------------------------------------------ embed
def cmd_embed(args) -> int:
    """Run the frozen-backbone embedding stage over a token corpus and
    persist the cache directory as the ``embed/`` stage artifact.

    ``--tokens`` is an ``(n, seq_len)`` int ``.npy`` (memmap-streamed; or
    ``(n, seq_len, d_frontend)`` floats for embed-frontend configs);
    ``-S EMBED_ARCH=<id>[:smoke]`` picks the backbone, ``EMBED_POOL`` the
    pooling, ``EMBED_BATCH`` the fixed batch shape, ``EMBED_SEED`` the
    deterministic frozen-init seed.  The output is write-through and
    crash-safe: re-running after an interruption computes only the missing
    shards, re-running after a config change rebuilds the artifact under
    the new fingerprint.  Downstream: ``train --data <model-dir>/embed``
    streams the shards, ``serve --tokens`` rebuilds the recorded extractor.
    """
    import shutil

    from repro_torch.api.config import split_embed_keys
    from repro_torch.embed import EmbeddingExtractor, EmbeddingSource, resolve_arch
    from repro_torch.embed.source import EmbedCache, EmbedCacheError, \
        TokenArraySource

    leftover, emb_kw = split_embed_keys(_setup_obs(_parse_sets(args.set)))
    if leftover:
        raise SystemExit(f"embed only takes the EMBED_* keys and the "
                         f"observability keys, got {sorted(leftover)}")
    if "arch" not in emb_kw:
        _fail("embed requires -S EMBED_ARCH=<arch-id>[:smoke] "
              "(see repro_torch.configs.ARCH_IDS)")
    emb_kw.pop("cache_dir", None)   # the artifact location is --model-dir
    arch = emb_kw.pop("arch")
    tok = TokenArraySource(args.tokens)
    ex = EmbeddingExtractor(resolve_arch(arch), device=args.device,
                            **emb_kw)
    out_dir = os.path.join(args.model_dir, "embed")
    fp = ex.fingerprint(tok.seq_len)
    ident = dict(n_rows=tok.n_rows, dim=ex.dim, block=ex.batch_size,
                 seq_len=tok.seq_len,
                 extra={"arch": arch, "pooling": ex.pooling,
                        "seed": ex.seed})
    rebuilt = False
    try:
        cache = EmbedCache(out_dir, fp, **ident)
    except EmbedCacheError:
        # different corpus/arch/pooling than the previous run: the stage
        # artifact is being re-produced, like re-running train over it
        shutil.rmtree(out_dir)
        cache = EmbedCache(out_dir, fp, **ident)
        rebuilt = True
    src = EmbeddingSource(tok, ex, cache=cache)
    already = src.cache_complete()
    for _ in src.iter_chunks(args.chunk_size or 4096):
        pass                        # drive the write-through pass
    assert src.cache_complete()
    _emit(_finish_obs(
        {"stage": "embed", "n": src.n_rows, "d": src.dim,
         "seq_len": tok.seq_len, "arch": arch, "pooling": ex.pooling,
         "fingerprint": fp, "shards": cache.n_blocks,
         "cache_hit": bool(already), "rebuilt": rebuilt,
         "cache_dir": out_dir, "model_dir": args.model_dir}))
    return 0


# ------------------------------------------------------------------ train
def cmd_train(args) -> int:
    from repro_torch.api.config import apply_keys
    from repro_torch.api.session import SVM
    from repro_torch.train.svm_trainer import SVMTrainerConfig

    from repro_torch.api.config import weight_grid

    scenario = _SCENARIOS[args.scenario]
    cfg, select_params = apply_keys(
        SVMTrainerConfig(scenario=scenario), _setup_obs(_parse_sets(args.set)))
    if cfg.weights == (1.0,):
        # npl/roc are weight-sweep scenarios: without an explicit
        # WEIGHTS/MIN_WEIGHT/... key, give them the front-ends' default
        # grids rather than a degenerate single-weight axis
        if args.scenario == "npl" or scenario == "npsvm":
            cfg = dataclasses.replace(cfg, weights=weight_grid(0.25, 4.0, 5))
        elif args.scenario == "roc":
            cfg = dataclasses.replace(cfg,
                                      weights=weight_grid(1.0 / 9.0, 9.0, 9))
    x = _load_data(args.data)
    y = np.load(args.labels)

    sess = SVM(x, y, config=cfg, device=args.device,
               select_rule=_SCENARIO_RULES.get(args.scenario),
               select_kwargs=select_params)
    ckpt = os.path.join(args.model_dir, "waves") if args.resumable else None
    tr = sess.train(ckpt_dir=ckpt)
    tr.save(os.path.join(args.model_dir, "train"))
    # stage hand-off for select: the scenario's default rule + key params
    with open(os.path.join(args.model_dir, "session.json"), "w") as f:
        json.dump({"select_rule": sess.select_rule,
                   "select_kwargs": sess.select_kwargs}, f)
    _emit(_finish_obs(
        {"stage": "train", "n": tr.n, "d": tr.d,
         "cells": tr.plan.n_cells, "slots": tr.packed.n_slots,
         "grid": {"gammas": int(tr.gammas_cells.shape[1]),
                  "lambdas": int(tr.lambdas.shape[0]),
                  "tasks": int(tr.tasks.n_tasks),
                  "sub": int(tr.gamma.shape[2])},
         "model_dir": args.model_dir}))
    return 0


# ----------------------------------------------------------------- select
def cmd_select(args) -> int:
    from repro_torch.api.config import parse_keys
    from repro_torch.api.session import TrainResult

    tr = _load_artifact(args.model_dir, "train",
                        lambda p: TrainResult.load(p, device=args.device),
                        f"train --data ... --labels ... "
                        f"--model-dir {args.model_dir}")
    rule, kwargs = None, {}
    sess_path = os.path.join(args.model_dir, "session.json")
    if os.path.exists(sess_path):
        with open(sess_path) as f:
            saved = json.load(f)
        rule, kwargs = saved.get("select_rule"), saved.get("select_kwargs", {})
    if args.rule:
        rule = args.rule
    keys = parse_keys(_parse_sets(args.set))
    if "NPL_CONSTRAINT" in keys:
        kwargs["alpha"] = keys.pop("NPL_CONSTRAINT")
    if "NPL_CLASS" in keys:
        kwargs["npl_class"] = keys.pop("NPL_CLASS")
    if keys:
        raise SystemExit(f"select only takes NPL_CONSTRAINT/NPL_CLASS keys, "
                         f"got {sorted(keys)}")

    sel = tr.select(rule, **kwargs)
    # the staged cell rows already live in train/ next door — reference,
    # don't re-write, the O(n·d) arrays on every re-selection
    sel.save(os.path.join(args.model_dir, "select"),
             train_ref=os.path.join("..", "train"))
    bank = sel.to_bank()
    bank.save(os.path.join(args.model_dir, "bank"))
    payload = {"stage": "select", "rule": sel.rule, "stats": sel.stats,
               "bank": bank.stats(), "model_dir": args.model_dir}
    for k in ("np_fa", "np_det", "np_weight_idx", "roc_front"):
        if k in sel.extras:
            payload[k] = np.asarray(sel.extras[k]).tolist()
    _emit(payload)
    return 0


# ------------------------------------------------------------------- test
def cmd_test(args) -> int:
    from repro_torch.api.session import SelectResult

    sel = _load_artifact(args.model_dir, "select",
                         lambda p: SelectResult.load(p, device=args.device),
                         f"select --model-dir {args.model_dir}")
    x = _load_data(args.data)
    y = np.load(args.labels)
    res = sel.test(x, y, chunk_size=args.chunk_size)
    _emit({"stage": "test", "rule": sel.rule, "error": res.error,
           "n": res.n, **res.details})
    return 0


# ------------------------------------------------------------------ serve
def cmd_serve(args) -> int:
    """Cold-start the engine from ``bank/`` and serve ``--data`` through
    the latency-bounded async stepper.

    The bank's recorded routing mode (overlap for VORONOI=5 fits) applies
    unless overridden with ``-S SERVE_OVERLAP=...``; ``-S DEADLINE_MS=...``
    bounds queueing latency; ``-S MAX_QUEUE=...`` bounds admission (overflow
    batches are shed, not queued).  ``--out`` writes predicted labels.

    ``--swap-watch`` polls ``bank/`` every ``SWAP_POLL_MS`` (default 500)
    between arrival bursts; when a STRICTLY newer bank version appears
    (``select`` re-run, or an incremental ``repro_torch.serve.refresh``
    write),
    it is hot-swapped mid-traffic — in-flight waves finish on the old
    version, later admissions serve the new one.  A bank dir caught
    mid-write is skipped and retried at the next poll.

    Monitor keys (``-S SLO_P99_MS=... / DRIFT_WINDOW=... /
    DRIFT_REFRESH_THRESHOLD=...``) attach a
    :class:`repro_torch.serve.monitor.HealthMonitor`; the final payload then carries a
    ``health`` verdict.  With ``--swap-watch`` AND a labelled feedback pool
    (``--feedback-data``/``--feedback-labels``) the loop CLOSES: a cell
    whose drift score crosses ``DRIFT_REFRESH_THRESHOLD`` triggers a
    targeted ``refresh_drifted`` (only the drifted cells re-solve), the
    bumped bank is written to ``bank/`` and hot-swapped mid-traffic, and
    each trigger is traced (``serve.drift_refresh``) and counted
    (``serve.drift_refreshes``).  Closing the loop needs the ``train/``
    and ``select/`` artifacts next to ``bank/``.
    """
    from repro_torch.api.config import split_monitor_keys, split_serve_keys
    from repro_torch.serve.model_bank import ModelBank
    from repro_torch.serve.svm_engine import SVMEngine
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.tasks.builder import combine_decisions
    from repro_torch import obs
    import time as _time

    leftover, mon_kw = split_monitor_keys(_setup_obs(_parse_sets(args.set)))
    leftover, serve_kw = split_serve_keys(leftover)
    # the bank watcher's interval is the serve loop's, not the engine's
    poll_ms = serve_kw.pop("swap_poll_ms", None) or 500.0
    if leftover:
        raise SystemExit(f"serve only takes SERVE_OVERLAP/DEADLINE_MS/"
                         f"MAX_QUEUE/SWAP_POLL_MS, the monitor keys "
                         f"(SLO_P99_MS/DRIFT_WINDOW/DRIFT_REFRESH_THRESHOLD) "
                         f"and the observability keys (TRACE/TRACE_OUT/"
                         f"METRICS_OUT/PROFILE_DIR), got {sorted(leftover)}")
    if (args.feedback_data is None) != (args.feedback_labels is None):
        _fail("--feedback-data and --feedback-labels go together")
    if (args.data is None) == (args.tokens is None):
        _fail("serve takes exactly one of --data (feature space) or "
              "--tokens (token space, in-process embedding)")
    bank_dir = os.path.join(args.model_dir, "bank")
    bank = _load_artifact(args.model_dir, "bank", ModelBank.load,
                          f"select --model-dir {args.model_dir}")
    eng = SVMEngine(bank, device=args.device, **serve_kw)

    # token-space serving: rebuild the extractor the embed stage recorded
    # and co-locate it with the engine (EmbedServe); the per-request
    # breakdown then carries the embed_ms stage and the monitor's drift
    # scores watch embedding-space routing distances
    serve_obj, tok, src = eng, None, None
    if args.tokens is not None:
        from repro_torch.embed import EmbeddingExtractor, resolve_arch
        from repro_torch.embed.source import EmbedCache, EmbedCacheError, \
            TokenArraySource
        from repro_torch.serve.embed_engine import EmbedServe
        embed_dir = os.path.join(args.model_dir, "embed")
        try:
            emeta = EmbedCache.open(embed_dir)
        except EmbedCacheError as e:
            _fail(f"{e} — `serve --tokens` needs the embed/ artifact; run "
                  f"`python -m repro_torch.cli embed --model-dir "
                  f"{args.model_dir}` first")
        ex = EmbeddingExtractor(resolve_arch(emeta["arch"]),
                                pooling=emeta["pooling"],
                                batch_size=emeta["block"],
                                seed=emeta["seed"], device=args.device)
        tok = TokenArraySource(args.tokens)
        serve_obj = EmbedServe(eng, ex)
    else:
        src = _load_data(args.data)

    mon = None
    if mon_kw or args.feedback_data is not None:
        from repro_torch.serve.monitor import HealthMonitor
        mon = HealthMonitor(eng, **mon_kw)

    # the refresh half of the closed loop: needs the fit context (train/,
    # select/) and a labelled feedback pool to re-solve drifted cells from
    tr = sel = x_feed = y_feed = None
    if args.feedback_data is not None:
        if not args.swap_watch:
            _fail("--feedback-data closes the drift->refresh loop; it "
                  "requires --swap-watch")
        from repro_torch.api.session import SelectResult, TrainResult
        tr = _load_artifact(args.model_dir, "train",
                            lambda p: TrainResult.load(p, device=args.device),
                            f"train --model-dir {args.model_dir}")
        sel = _load_artifact(args.model_dir, "select",
                             lambda p: SelectResult.load(p,
                                                         device=args.device),
                             f"select --model-dir {args.model_dir}")
        x_feed = _load_data(args.feedback_data).materialize()
        y_feed = np.load(args.feedback_labels)
        if x_feed.shape[0] != y_feed.shape[0]:
            _fail(f"feedback rows mismatch: {x_feed.shape[0]} data vs "
                  f"{y_feed.shape[0]} labels")

    swaps_seen = {"polls": 0}
    triggers: List[dict] = []
    refreshed_slots: set = set()

    def _maybe_swap(last_poll: list) -> None:
        now = _time.monotonic()
        if (now - last_poll[0]) * 1e3 < poll_ms:
            return
        last_poll[0] = now
        swaps_seen["polls"] += 1
        try:
            extra = ckpt_mod.peek_manifest(bank_dir)["extra"]
            if int(extra.get("version", 0)) > int(eng.bank.version):
                eng.swap_bank(ModelBank.load(bank_dir))
        except (ckpt_mod.CheckpointCorruptError, FileNotFoundError,
                OSError, ValueError):
            pass                   # mid-write / torn bank: retry next poll

    def _maybe_refresh() -> None:
        """Drift crossed the threshold -> refresh ONLY those cells, write
        the bumped bank and hot-swap it under the live traffic."""
        from repro_torch.serve.refresh import refresh_drifted
        drifted = [c for c in mon.drifted_cells() if c not in refreshed_slots]
        if not drifted:
            return
        refreshed_slots.update(drifted)   # one shot per slot per run
        with obs.tracer.span("serve.drift_refresh") as sp:
            sp.set(cells=len(drifted))
            bank1, info = refresh_drifted(tr, sel, x_feed, y_feed, drifted,
                                          base_version=eng.bank.version)
        rec = {"cells": drifted, "scores": mon.drift_scores(), **info}
        if bank1 is not None:
            bank1.save(bank_dir, step=bank1.version)
            eng.swap_bank(bank1)
            obs.metrics.counter("serve.drift_refreshes").inc()
            mon.reset_cells(drifted)
            rec["version"] = bank1.version
        triggers.append(rec)

    def arrivals():
        if src is not None:
            for _, chunk in src.iter_chunks(args.wave):
                yield chunk
        else:
            for lo in range(0, tok.n_rows, args.wave):
                yield tok.rows(lo, min(lo + args.wave, tok.n_rows))

    def traffic():
        last_poll = [float("-inf")]
        for chunk in arrivals():
            if args.swap_watch:
                _maybe_swap(last_poll)
            if tr is not None:
                _maybe_refresh()
            yield chunk

    n_in = int(src.n_rows if src is not None else tok.n_rows)
    t0 = _time.time()
    results = (serve_obj.run_tokens(traffic()) if tok is not None
               else eng.run(traffic()))
    dt = _time.time() - t0
    dec = (np.stack([results[i] for i in sorted(results)]) if results
           else np.zeros((0, bank.n_tasks, bank.n_sub), np.float32))
    pred = combine_decisions(dec, bank.scenario, classes=bank.classes,
                             pairs=bank.pairs, sub=bank.default_sub)
    if args.out:
        np.save(args.out, pred)
    stats = serve_obj.stats()
    payload = {"stage": "serve", "n": n_in,
               "rps": n_in / max(dt, 1e-9),
               "routing": stats["routing"],
               "deadline_ms": serve_kw.get("deadline_ms"),
               "waves": stats.get("waves", 0),
               "occupancy_mean": stats.get("occupancy_mean"),
               "age_ms_max": stats.get("age_ms_max"),
               "per_stage": stats["per_stage"],
               "bank_version": stats["bank_version"],
               "swaps": stats["swaps"],
               "swap_requeued": stats["swap_requeued"],
               "shed_rows": stats["shed_rows"],
               "swap_polls": swaps_seen["polls"],
               "out": args.out, "model_dir": args.model_dir}
    if mon is not None:
        payload["health"] = mon.health()
        payload["drift_triggers"] = triggers
    _emit(_finish_obs(payload))
    return 0


# ------------------------------------------------------------------- main
def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.cli",
        description="staged liquidSVM cycle: train -> select -> test")
    sub = p.add_subparsers(dest="cmd", required=True)

    bp = sub.add_parser("embed", help="frozen-backbone embedding stage: "
                                      "token corpus -> embed/ cache artifact")
    bp.add_argument("--tokens", required=True,
                    help="(n, seq_len) int .npy token corpus "
                         "(memmap-streamed)")
    bp.add_argument("--model-dir", required=True)
    bp.add_argument("--chunk-size", type=int, default=None,
                    help="rows per driving chunk (default 4096)")
    bp.add_argument("-S", "--set", action="append", metavar="KEY=VALUE",
                    help="EMBED_ARCH (required) / EMBED_POOL / EMBED_BATCH "
                         "/ EMBED_SEED + observability keys")
    bp.set_defaults(fn=cmd_embed)

    tp = sub.add_parser("train", help="solve the fold x grid, keep the "
                                      "CV surface")
    tp.add_argument("--data", required=True,
                    help=".npy path (memmap-streamed) or .npz shard list")
    tp.add_argument("--labels", required=True, help=".npy label vector")
    tp.add_argument("--model-dir", required=True)
    tp.add_argument("--scenario", default="binary",
                    choices=sorted(_SCENARIOS))
    tp.add_argument("-S", "--set", action="append", metavar="KEY=VALUE",
                    help="string config key (repeatable); --help-keys lists")
    tp.add_argument("--resumable", action="store_true",
                    help="per-wave checkpointing under <model-dir>/waves")
    tp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("select", help="(re-)pick hyper-parameters over the "
                                       "retained surface; writes the bank")
    sp.add_argument("--model-dir", required=True)
    sp.add_argument("--rule", default=None,
                    help="argmin|npl|roc|quantile|expectile "
                         "(default: the trained scenario's rule)")
    sp.add_argument("-S", "--set", action="append", metavar="KEY=VALUE",
                    help="NPL_CONSTRAINT / NPL_CLASS")
    sp.set_defaults(fn=cmd_select)

    ep = sub.add_parser("test", help="stream the scenario error")
    ep.add_argument("--data", required=True)
    ep.add_argument("--labels", required=True)
    ep.add_argument("--model-dir", required=True)
    ep.add_argument("--chunk-size", type=int, default=None)
    ep.set_defaults(fn=cmd_test)

    vp = sub.add_parser("serve", help="cold-start the engine from bank/ and "
                                      "serve --data (async, latency-bounded)")
    vp.add_argument("--data", default=None,
                    help="feature-space queries (.npy / .npz shards / "
                         "embed/ dir)")
    vp.add_argument("--tokens", default=None,
                    help="token-space queries (.npy): embed in-process via "
                         "the recorded embed/ extractor (EmbedServe)")
    vp.add_argument("--model-dir", required=True)
    vp.add_argument("--wave", type=int, default=256,
                    help="arrival burst size fed to the stepper")
    vp.add_argument("--out", default=None,
                    help="write predicted labels to this .npy")
    vp.add_argument("--swap-watch", action="store_true",
                    help="poll bank/ for newer versions and hot-swap "
                         "mid-traffic (interval: -S SWAP_POLL_MS)")
    vp.add_argument("--feedback-data", default=None,
                    help="labelled feedback pool: close the drift->refresh "
                         "loop (needs --swap-watch and train/+select/)")
    vp.add_argument("--feedback-labels", default=None,
                    help=".npy labels for --feedback-data")
    vp.add_argument("-S", "--set", action="append", metavar="KEY=VALUE",
                    help="SERVE_OVERLAP / DEADLINE_MS / MAX_QUEUE / "
                         "SWAP_POLL_MS / SLO_P99_MS / DRIFT_WINDOW / "
                         "DRIFT_REFRESH_THRESHOLD / TRACE / TRACE_OUT / "
                         "METRICS_OUT / PROFILE_DIR")
    vp.set_defaults(fn=cmd_serve)
    for sp_ in (bp, tp, sp, ep, vp):
        sp_.add_argument("--device", default=None,
                         help="cuda[:i] (default: the current card) or cpu "
                              "(the plain PyTorch path)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--help-keys" in argv:
        from repro_torch.api.config import describe_keys
        print(describe_keys())
        return 0
    args = _build_parser().parse_args(argv)
    from repro_torch.kernels import runtime
    try:
        args.device = runtime.resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        _fail(f"{e} (--device cpu runs the plain PyTorch path)")
    from repro_torch.api.config import ConfigError
    from repro_torch.embed.source import EmbedCacheError
    from repro_torch.pipeline.dataset import DataSourceError
    from repro_torch.train.checkpoint import CheckpointCorruptError
    try:
        return args.fn(args)
    except (ConfigError, DataSourceError, CheckpointCorruptError,
            EmbedCacheError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
