"""LM serving engine: batched prefill + autoregressive decode.

``serve_step`` is one new token against a full cache; ``generate`` is the
host-side loop (greedy, or sampled from an explicit ``torch.Generator``)
with a per-row "done" mask for early stopping.  On a CUDA tensor the
prefill runs the flash attention kernel (B9) once per attention layer and
every decode step runs the fused decode kernel (B10) once per layer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import model as model_mod
from repro_torch.models.model import ModelConfig
from repro_torch.serve.kv_cache import pad_cache


def serve_step(cfg: ModelConfig, params, token: torch.Tensor,
               cache: Dict[str, Any], pos: int
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: token (B, 1) -> (logits (B, vocab), cache)."""
    return model_mod.decode_step(cfg, params, token, cache, pos)


def prefill_step(cfg: ModelConfig, params, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    return model_mod.prefill(cfg, params, tokens)


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(
    cfg: ModelConfig,
    params,
    prompt: torch.Tensor,          # (B, T_prompt) int
    max_new_tokens: int,
    temperature: float = 0.0,
    eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Greedy/sampled generation.  Returns (B, T_prompt + max_new_tokens)
    int32 on the prompt's device.  ``temperature > 0`` samples from
    ``generator`` (on the prompt's device)."""
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    b, t0 = prompt.shape
    budget = t0 + max_new_tokens
    logits, cache = prefill_step(cfg, params, prompt)
    cache = pad_cache(cfg, cache, budget)

    tokens = [prompt.to(torch.int32)]
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    cur = _sample(logits, generator, temperature).to(torch.int32)

    for step in range(max_new_tokens):
        if eos_id is not None:
            done = done | (cur == eos_id)
            cur = torch.where(done, torch.full_like(cur, eos_id), cur)
        tokens.append(cur[:, None])
        if step == max_new_tokens - 1:
            break
        logits, cache = serve_step(cfg, params, cur[:, None], cache,
                                   t0 + step)
        cur = _sample(logits, generator, temperature).to(torch.int32)
        if eos_id is not None and bool(done.all()):
            tokens.append(torch.full((b, max_new_tokens - step - 1), eos_id,
                                     dtype=torch.int32, device=prompt.device))
            break
    return torch.cat(tokens, dim=1)[:, :budget]
