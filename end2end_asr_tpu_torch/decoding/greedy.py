"""Batched greedy decoding with a KV cache.

Port of the JAX package's ``decoding/greedy.py``. Reference:
Decoder.greedy_search (models/asr/transformer.py:316-394) re-runs the
whole decoder over the growing prefix at each of 300 steps; here each
step is one KV-cached `decode_step` (numerically the same with dropout
off), and the loop ends as soon as every utterance has emitted EOS.

Inference-mode quirks kept: non-pad mask of ones and NO cross-attention
mask (transformer.py:336-348), host-side string cut at the first EOS
(transformer.py:385-394).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from end2end_asr_tpu_torch.config import EOS_TOKEN, SOS_TOKEN
from end2end_asr_tpu_torch.models import decoder as D
from end2end_asr_tpu_torch.models.transformer import ModelDims


@torch.inference_mode()
def greedy_decode(params: Dict, enc_out: torch.Tensor, dims: ModelDims,
                  max_len: int = 300) -> torch.Tensor:
    """enc_out: (B, T_enc, H). Returns generated ids (B, max_len) int64;
    positions after each utterance's first EOS hold EOS."""
    B = enc_out.shape[0]
    dev = enc_out.device
    dec = params["decoder"]
    cache = D.init_cache(dec, enc_out, max_len, dims.num_heads,
                         dims.dim_key, dims.dim_value, dtype=dims.dtype)
    out = torch.full((B, max_len), EOS_TOKEN, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    token = torch.full((B,), SOS_TOKEN, dtype=torch.long, device=dev)
    eos = torch.full_like(token, EOS_TOKEN)
    for t in range(max_len):
        logits = D.decode_step(dec, cache, token, t, dims.num_heads,
                               dims.dim_key, dims.dim_value, dims.dim_model,
                               emb_trg_sharing=dims.emb_trg_sharing,
                               dtype=dims.dtype)
        token = torch.where(done, eos, logits.argmax(dim=-1))
        out[:, t] = token
        done |= token == EOS_TOKEN
        if bool(done.all()):
            break
    return out


def greedy_decode_progressive(params: Dict, enc_out: torch.Tensor,
                              dims: ModelDims, max_len: int = 300,
                              stage_len: int = 64) -> torch.Tensor:
    """Exact two-stage greedy: decode with a short KV cache first and
    re-run at full length only if some utterance never emitted EOS.
    Attention reads positions <= t only, so tokens before the first EOS
    are the same at any cache length. Returns (B, max_len)."""
    if stage_len >= max_len:
        return greedy_decode(params, enc_out, dims, max_len=max_len)
    ids1 = greedy_decode(params, enc_out, dims, max_len=stage_len)
    if bool((ids1 == EOS_TOKEN).any(dim=1).all()):
        pad = torch.full((ids1.shape[0], max_len - stage_len), EOS_TOKEN,
                         dtype=ids1.dtype, device=ids1.device)
        return torch.cat([ids1, pad], dim=1)
    return greedy_decode(params, enc_out, dims, max_len=max_len)


def ids_to_strings(ids, id2label: Dict[int, str]) -> List[str]:
    """Host-side: chars until the first EOS (exclusive), like
    transformer.py:385-394. The leading SOS char, if emitted, stays in
    the string (callers strip specials)."""
    out = []
    for row in torch.as_tensor(ids).cpu().tolist():
        s = ""
        for tok in row:
            if tok == EOS_TOKEN:
                break
            s += id2label.get(tok, "")
        out.append(s)
    return out
