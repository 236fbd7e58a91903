"""End-to-end LM training on the PyTorch/CUDA port: a ~100M-parameter LM
for a few hundred steps with checkpoints.

    PYTHONPATH=src python examples/torch_train_lm_e2e.py            # ~100M, 150 steps, the card
    PYTHONPATH=src python examples/torch_train_lm_e2e.py --preset small --steps 60
    PYTHONPATH=src python examples/torch_train_lm_e2e.py --device cpu --preset tiny --steps 12

The twin of ``examples/train_lm_e2e.py`` through
``repro_torch.train.lm_trainer``.  The model is the stablelm family block
at reduced width, in the port's compute dtype (bf16, with the optimizer's
f32 master weights and moments); everything else is the production path:
AdamW, cosine schedule, gradient accumulation, atomic checkpoints in the
JAX package's format (``--ckpt-dir``, a temporary directory by default),
deterministic data replay: a rerun with the same ``--ckpt-dir`` resumes
from the newest checkpoint.

It runs on the card unless ``--device cpu`` is given, and raises without
one.  The last line is one JSON object: the first and last losses.
"""
import argparse
import json
import shutil
import tempfile

from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.kernels import runtime
from repro_torch.models.model import ModelConfig
from repro_torch.train.lm_trainer import Trainer, TrainLoopConfig
from repro_torch.train.optimizer import OptConfig

PRESETS = {
    # ~101M params: 12L x d512 x ff2048, vocab 32768
    "100m": dict(n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab=32768, batch=8, seq=256),
    # ~8M
    "small": dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                  head_dim=32, d_ff=512, vocab=2048, batch=8, seq=64),
    # ~0.2M: for CI-speed runs on a CPU
    "tiny": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                 head_dim=16, d_ff=128, vocab=512, batch=8, seq=32),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="100m", choices=list(PRESETS))
    # 150 steps keep a run on one card within a minute (the JAX package's
    # script takes 300)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoints here (default: a temporary directory, "
                         "removed at the end)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    dev = runtime.resolve_device(args.device)    # raises without a card
    print(f"device: {dev}")

    p = PRESETS[args.preset]
    cfg = ModelConfig(
        name=f"lm-{args.preset}", n_layers=p["n_layers"], d_model=p["d_model"],
        n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"], head_dim=p["head_dim"],
        d_ff=p["d_ff"], vocab=p["vocab"],
        period_pattern=(("attn", "dense"),), rotary_frac=0.25,
        norm="layernorm", act="silu", remat=False, ce_chunk=128)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="lm_ckpt_")
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=p["seq"], global_batch=p["batch"], seed=0))
    trainer = Trainer(
        cfg,
        OptConfig(lr=1e-3, warmup_steps=max(args.steps // 20, 5),
                  total_steps=args.steps),
        TrainLoopConfig(total_steps=args.steps, grad_accum=args.grad_accum,
                        ckpt_every=max(args.steps // 4, 10),
                        ckpt_dir=ckpt_dir, log_every=10),
        pipe, device=dev)
    try:
        out = trainer.run()
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    for h in out["history"]:
        print(json.dumps(h))
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({out['wall_s']:.0f}s)")
    print(json.dumps({"device": str(dev), "preset": args.preset,
                      "steps": args.steps, "loss_first": first,
                      "loss_last": last, "wall_s": out["wall_s"]}))
    assert last < first, "training must reduce loss"


if __name__ == "__main__":
    main()
