"""Batched beam search with slot-local KV caches.

Port of the JAX package's ``decoding/beam.py``. Reference:
Decoder.beam_search (models/asr/transformer.py:396-517). The beam
dimension is folded into the batch ((B, W) → B·W rows) and each step is
one KV-cached decode_step whose self-attention reads the caches through
an ancestry table (models/decoder._attend_beam), so the caches are never
reordered.

Semantics kept from the reference and the JAX package:
  * expansion: each alive hypothesis proposes its tokens; keep the best W
    by cumulative log-prob (transformer.py:445-462);
  * a hypothesis whose chosen token is EOS retires to a finished pool and
    is NOT refilled (:469-492);
  * when the search runs to enc_T - 1 steps, every still-alive
    hypothesis gets EOS appended WITHOUT adding its log-prob (:464-467);
  * final ranking on the host: final = score + sqrt(num_words)·c_weight
    (+ lm_weight·(lm_score − 2·oov) with sqrt(lm_num_words) in place of
    sqrt(num_words) when LM-rescoring, :473-488) over the finished pool,
    which keeps the best pool_factor·W finished hypotheses by raw score
    (exact when pool_factor >= n_steps + 1);
  * empty pool for an utterance → greedy fallback for that utterance.

Top-k selections break ties toward the lower index, as jax.lax.top_k
does (a stable descending sort), and rows are gathered with index
gathers.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from end2end_asr_tpu_torch.config import (Config, EOS_CHAR, EOS_TOKEN,
                                          PAD_CHAR, SOS_CHAR, SOS_TOKEN)
from end2end_asr_tpu_torch.decoding.greedy import (greedy_decode,
                                                   ids_to_strings)
from end2end_asr_tpu_torch.decoding.lm_rescoring import calculate_lm_score
from end2end_asr_tpu_torch.models import decoder as D
from end2end_asr_tpu_torch.models.transformer import ModelDims

NEG = -1.0e30
POOL_FACTOR = 4
# use the exact pool (pool_factor = n_steps + 1) when its token table
# (P·L = (n+1)·W·(n+2) elements) is at most this big
AUTO_EXACT_POOL_ELEMS = 1 << 17


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last dim, ties to the lower index (lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) → x[b, rows[b, i], ...] for rows (B, M)."""
    idx = rows.reshape(rows.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(rows.shape + x.shape[2:]))


@torch.inference_mode()
def beam_search(params: Dict, enc_out: torch.Tensor, dims: ModelDims,
                W: int, n_steps: int, force_eos: bool,
                pool_factor: int = POOL_FACTOR):
    """Returns (pool_tokens (B,P,L), pool_scores (B,P), pool_lens (B,P),
    unfinished (B,) bool — True where the step cap was hit with alive
    hypotheses). L = n_steps + 2; invalid entries score <= NEG/2."""
    B = enc_out.shape[0]
    dev = enc_out.device
    dec = params["decoder"]
    P = pool_factor * W
    L = n_steps + 2
    cache = D.init_cache(dec, enc_out, L, dims.num_heads, dims.dim_key,
                         dims.dim_value, dtype=dims.dtype, beam_W=W)

    long = dict(dtype=torch.long, device=dev)
    tokens = torch.full((B, W, L), EOS_TOKEN, **long)
    tokens[:, :, 0] = SOS_TOKEN
    scores = torch.full((B, W), NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    alive = torch.zeros((B, W), dtype=torch.bool, device=dev)
    alive[:, 0] = True
    anc = torch.zeros((B, W, L), **long)
    slots = torch.arange(W, **long)

    pool_t = torch.full((B, P, L), EOS_TOKEN, **long)
    pool_s = torch.full((B, P), NEG, dtype=torch.float32, device=dev)
    pool_l = torch.zeros((B, P), **long)

    def insert_pool(pool_t, pool_s, pool_l, new_t, new_s, new_l):
        top_s, top_i = _top_k(torch.cat([pool_s, new_s], dim=1), P)
        return (_take_rows(torch.cat([pool_t, new_t], dim=1), top_i),
                top_s, _take_rows(torch.cat([pool_l, new_l], dim=1), top_i))

    t = 0
    while t < n_steps and bool(alive.any()):
        last = tokens[:, :, t].reshape(B * W)
        anc[:, :, t] = slots          # position t written by each slot
        logits = D.decode_step(dec, cache, last, t, dims.num_heads,
                               dims.dim_key, dims.dim_value, dims.dim_model,
                               emb_trg_sharing=dims.emb_trg_sharing,
                               dtype=dims.dtype, beam=(W, anc))
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        logp = logp.reshape(B, W, V)
        cand = torch.where(alive[:, :, None], scores[:, :, None] + logp,
                           torch.full_like(logp, NEG))
        top_s, top_i = _top_k(cand.reshape(B, W * V), W)
        parent = top_i // V
        tok = top_i % V

        tokens = _take_rows(tokens, parent)
        tokens[:, :, t + 1] = tok
        anc = _take_rows(anc, parent)
        valid = _take_rows(alive, parent) & (top_s > NEG / 2)
        ended = valid & (tok == EOS_TOKEN)
        alive = valid & ~ended

        end_s = torch.where(ended, top_s, torch.full_like(top_s, NEG))
        end_l = torch.full((B, W), t + 2, **long)
        pool_t, pool_s, pool_l = insert_pool(pool_t, pool_s, pool_l,
                                             tokens, end_s, end_l)
        scores = torch.where(alive, top_s, torch.full_like(top_s, NEG))
        t += 1
    unfinished = alive.any(dim=1)

    if force_eos:
        # transformer.py:464-467: survivors get EOS (no added log-prob)
        forced_t = tokens.clone()
        forced_t[:, :, n_steps + 1] = EOS_TOKEN
        forced_s = torch.where(alive, scores, torch.full_like(scores, NEG))
        forced_l = torch.full((B, W), n_steps + 2, **long)
        pool_t, pool_s, pool_l = insert_pool(pool_t, pool_s, pool_l,
                                             forced_t, forced_s, forced_l)
    return pool_t, pool_s, pool_l, unfinished


class Hyp(NamedTuple):
    """One n-best entry: token ids (SOS…EOS), decoded string (yseq[1:],
    specials included, like post_process_hyp transformer.py:307-314),
    final rank score, and raw cumulative log-prob."""
    ids: List[int]
    text: str
    final: float
    raw: float


class BeamDecoder:
    """Host wrapper: device beam → host final scoring (with LM rescoring
    when `lm`, a models.lm.LM, is given and cfg.lm_rescoring is set) →
    n-best."""

    def __init__(self, cfg: Config, dims: ModelDims,
                 id2label: Dict[int, str], lm=None,
                 pool_factor: int = POOL_FACTOR, stage_len: int = 64):
        self.cfg = cfg
        self.dims = dims
        self.id2label = id2label
        self.lm = lm
        self.pool_factor = pool_factor
        # short-cache first stage for decode_nbest (0 disables)
        self.stage_len = stage_len

    def _pool_factor_for(self, W: int, n_steps: int) -> int:
        exact = n_steps + 1
        if self.pool_factor >= exact:
            return exact
        if exact * W * (n_steps + 2) <= AUTO_EXACT_POOL_ELEMS:
            return exact
        return self.pool_factor

    def _final_score(self, ids: np.ndarray, raw_score: float,
                     length: int) -> float:
        """transformer.py:473-488: strip specials, collapse double
        spaces, add the word-count bonus, or the LM score and the LM's
        word-count bonus when LM-rescoring."""
        if self.lm is not None and self.cfg.lm_rescoring:
            lm_score, lm_num_words, oov = calculate_lm_score(
                ids[:length], self.lm, self.id2label)
            return (raw_score + self.cfg.lm_weight * (lm_score - 2 * oov)
                    + math.sqrt(lm_num_words) * self.cfg.c_weight)
        chars = "".join(self.id2label.get(int(x), "")
                        for x in ids[:length])
        seq_str = (chars.replace(PAD_CHAR, "").replace(SOS_CHAR, "")
                   .replace(EOS_CHAR, "")).replace("  ", " ")
        return raw_score + math.sqrt(len(seq_str.split())) * self.cfg.c_weight

    def decode_nbest(self, params, enc_out: torch.Tensor,
                     nbest: Optional[int] = None) -> List[List[Hyp]]:
        """Per utterance, up to nbest `Hyp`s ranked by final score
        (transformer.py:498-517)."""
        cfg = self.cfg
        nbest = nbest or 1
        B, T_enc = enc_out.shape[0], enc_out.shape[1]
        n_steps = min(cfg.decode_max_len, T_enc, cfg.tgt_max_len - 1)
        force = T_enc <= cfg.decode_max_len
        # exact two-stage search: a short cache first; if any utterance
        # still had alive hypotheses at the short cap, re-run in full
        pool = None
        if self.stage_len and self.stage_len < n_steps:
            pool = beam_search(
                params, enc_out, self.dims, cfg.beam_width, self.stage_len,
                False, pool_factor=self._pool_factor_for(cfg.beam_width,
                                                         self.stage_len))
            if bool(pool[3].any()):
                pool = None
        if pool is None:
            pool = beam_search(
                params, enc_out, self.dims, cfg.beam_width, n_steps, force,
                pool_factor=self._pool_factor_for(cfg.beam_width, n_steps))
        pool_t, pool_s, pool_l = (x.cpu().numpy() for x in pool[:3])

        results: List[List[Hyp]] = []
        need_greedy = []
        for b in range(B):
            cands = []
            for p in range(pool_t.shape[1]):
                if pool_s[b, p] <= NEG / 2:
                    continue
                final = self._final_score(pool_t[b, p], float(pool_s[b, p]),
                                          int(pool_l[b, p]))
                cands.append((final, p))
            cands.sort(reverse=True)
            utt = []
            for final, p in cands[:nbest]:
                ids = pool_t[b, p, :int(pool_l[b, p])].tolist()
                s = "".join(self.id2label.get(int(x), "") for x in ids[1:])
                utt.append(Hyp(ids, s, final, float(pool_s[b, p])))
            results.append(utt)
            if not utt:
                need_greedy.append(b)

        if need_greedy:
            # greedy fallback (reference: transformer.py:114-116)
            ids = greedy_decode(params, enc_out, self.dims,
                                max_len=min(cfg.decode_max_len,
                                            cfg.tgt_max_len))
            strs = ids_to_strings(ids, self.id2label)
            ids = ids.cpu().numpy()
            for b in need_greedy:
                row = ids[b].tolist()
                cut = (row.index(EOS_TOKEN) + 1 if EOS_TOKEN in row
                       else len(row))
                results[b] = [Hyp([SOS_TOKEN] + row[:cut], strs[b],
                                  float("-inf"), float("-inf"))]
        return results

    def decode(self, params, enc_out: torch.Tensor) -> List[str]:
        """1-best strings per utterance."""
        return [utt[0].text if utt else ""
                for utt in self.decode_nbest(params, enc_out, nbest=1)]
