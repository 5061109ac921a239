"""SpecAugment (Park et al., 2019): frequency and time masks on the batched
spectrogram inside the train step.

Port of the JAX package's ``ops/specaugment.py``, split in two so that the
masking can be held against it on the same draws:

  * `draw` takes the band positions from an explicit ``torch.Generator``
    (the step's own stream, apart from dropout's);
  * `mask` is a pure function of the spectrogram and the bands.

Kept from the JAX function: a frequency band has a width in
[0, freq_width] and starts below ``max(F - freq_width, 1)``; a time band's
width is clipped to the utterance's valid frames and it starts at
``floor(u * max(valid - width, 1))`` (`time_band`), so it lies in the valid
region; masked cells are set to 0, the per-utterance mean of the normalised
spectrogram.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def time_band(u: torch.Tensor, raw_width: torch.Tensor,
              n_frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, width) of time bands from uniform draws u in [0, 1) and
    raw widths in [0, time_width], both (B, n); n_frames (B,)."""
    valid = n_frames.clamp_min(1)[:, None]
    width = torch.minimum(raw_width, valid)
    max_start = (valid - width).clamp_min(1)
    start = (u.to(torch.float32) * max_start.to(torch.float32)).to(
        torch.int64)
    return start, width


def draw(gen: torch.Generator, B: int, F: int, n_frames: torch.Tensor,
         n_freq_masks: int = 2, freq_width: int = 27,
         n_time_masks: int = 2, time_width: int = 100,
         rows: Optional[Tuple[int, int]] = None):
    """(f_start, f_width (B, n_freq_masks), t_start, t_width
    (B, n_time_masks)) int64 on n_frames' device, drawn from `gen` (a
    generator on that device). `rows` = (first, total): the draws of a
    batch of `total` rows are made and rows [first, first + B) kept, so
    that a data-parallel rank masks its slice of the global batch as one
    process masks those rows."""
    dev = n_frames.device
    n_frames = n_frames.to(torch.int64)
    first, total = rows or (0, B)
    keep = slice(first, first + B)
    ri = lambda hi, n: torch.randint(0, hi, (total, n), generator=gen,
                                     device=dev, dtype=torch.int64)[keep]
    f_width = ri(freq_width + 1, n_freq_masks)
    f_start = ri(max(F - freq_width, 1), n_freq_masks)
    raw = ri(time_width + 1, n_time_masks)
    u = torch.rand((total, n_time_masks), generator=gen, device=dev)[keep]
    t_start, t_width = time_band(u, raw, n_frames)
    return f_start, f_width, t_start, t_width


def mask(spect: torch.Tensor, n_frames: torch.Tensor, f_start: torch.Tensor,
         f_width: torch.Tensor, t_start: torch.Tensor,
         t_width: torch.Tensor) -> torch.Tensor:
    """spect (B, F, T) with the bands set to 0. Bands are (B, n) integer
    tensors; n_frames is not used beyond `time_band` (the bands arrive
    clipped) and is kept for the call's symmetry with the JAX function."""
    del n_frames
    B, F, T = spect.shape
    f_idx = torch.arange(F, device=spect.device)[None, :, None]
    t_idx = torch.arange(T, device=spect.device)[None, :, None]
    fs, fw = f_start[:, None, :], f_width[:, None, :]
    ts, tw = t_start[:, None, :], t_width[:, None, :]
    f_band = ((f_idx >= fs) & (f_idx < fs + fw)).any(dim=-1)   # (B, F)
    t_band = ((t_idx >= ts) & (t_idx < ts + tw)).any(dim=-1)   # (B, T)
    keep = ~(f_band[:, :, None] | t_band[:, None, :])
    return torch.where(keep, spect, torch.zeros((), dtype=spect.dtype,
                                                device=spect.device))


def apply_spec_augment(gen: torch.Generator, spect: torch.Tensor,
                       n_frames: torch.Tensor, n_freq_masks: int = 2,
                       freq_width: int = 27, n_time_masks: int = 2,
                       time_width: int = 100,
                       rows: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    B, F, _ = spect.shape
    bands = draw(gen, B, F, n_frames, n_freq_masks, freq_width,
                 n_time_masks, time_width, rows)
    return mask(spect, n_frames, *bands)
