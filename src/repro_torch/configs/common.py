"""Shared config vocabulary for the ported architectures.

Every ``repro_torch/configs/<id>.py`` exports:
  CONFIG — the full-size ModelConfig (the published widths)
  SMOKE  — a reduced same-family config for CPU forward/parity tests
  SHAPES — the input-shape cells this arch runs

Shape semantics:
  train_4k     seq 4096  x global_batch 256   -> train_step
  prefill_32k  seq 32768 x global_batch 32    -> prefill_step
  decode_32k   seq 32768 x global_batch 128   -> serve_step (1 token vs cache)
  long_500k    seq 524288 x global_batch 1    -> serve_step, sub-quadratic only
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

ALL_SHAPES: Dict[str, dict] = {
    "train_4k":    dict(kind="train",   seq_len=4_096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32_768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524_288, global_batch=1),
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str         # train | prefill | decode | encode
    seq_len: int
    global_batch: int


def shapes_for(names: Tuple[str, ...], encoder_only: bool = False
               ) -> Tuple[ShapeSpec, ...]:
    out = []
    for n in names:
        s = ALL_SHAPES[n]
        kind = s["kind"]
        if encoder_only and kind == "prefill":
            kind = "encode"
        out.append(ShapeSpec(name=n, kind=kind, seq_len=s["seq_len"],
                             global_batch=s["global_batch"]))
    return tuple(out)
