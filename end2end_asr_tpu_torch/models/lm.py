"""Word-level LSTM language model for beam rescoring.

Port of the JAX package's ``models/lm.py``. Reference:
utils/lstm_utils.py:47-201, a torch LSTM LM (word2idx, ninp/nhid/nlayers,
optional tied weights) whose ``evaluate(seq)`` returns the summed
cross-entropy of the word sequence with <eos> appended and an <oov>
fallback.

The model is the reference's RNNModel in eval mode: an embedding, an
``nn.LSTM`` (gate order i, f, g, o, which is also the JAX package's) and
a decoder ``Linear``. With tied weights the decoder's weight IS the
embedding's Parameter, so a training gradient sums both uses (the JAX
package keeps no ``decoder_w`` leaf for a tied model, for the same
reason). Checkpoints load from the JAX package's ``.npz`` layout or the
reference's torch ``.pt`` layout; ``save_npz_lm`` writes the ``.npz``
layout, so either package reads the other's LM.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

LSTM_KEYS = (("w_ih", "weight_ih_l{}"), ("w_hh", "weight_hh_l{}"),
             ("b_ih", "bias_ih_l{}"), ("b_hh", "bias_hh_l{}"))


class RNNModel(nn.Module):
    """Embedding → nn.LSTM (batch first) → Linear, the reference's
    module names (encoder, rnn, decoder), so its state dict keys are the
    reference checkpoint's."""

    def __init__(self, ntoken: int, ninp: int, nhid: int, nlayers: int,
                 tie_weights: bool = False):
        super().__init__()
        if tie_weights and ninp != nhid:
            raise ValueError(
                f"--tie-weights requires ninp == nhid (got {ninp} vs "
                f"{nhid}), same as torch RNNModel")
        self.encoder = nn.Embedding(ntoken, ninp)
        self.rnn = nn.LSTM(ninp, nhid, nlayers, batch_first=True)
        self.decoder = nn.Linear(nhid, ntoken)
        if tie_weights:
            self.decoder.weight = self.encoder.weight

    @property
    def tied(self) -> bool:
        return self.decoder.weight is self.encoder.weight

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) int64 → logits (B, T, V)."""
        out, _ = self.rnn(self.encoder(tokens))
        return self.decoder(out)


def init_lm(ntoken: int, ninp: int, nhid: int, nlayers: int,
            tie_weights: bool, g: torch.Generator) -> RNNModel:
    """The JAX package's init_lstm_params semantics (reference
    lstm_utils.py:179-183): embedding and decoder U(-0.1, 0.1), decoder
    bias 0, LSTM weights U(-1/sqrt(nhid), 1/sqrt(nhid)), drawn from `g`."""
    model = RNNModel(ntoken, ninp, nhid, nlayers, tie_weights)
    bound = 1.0 / math.sqrt(nhid)
    with torch.no_grad():
        model.encoder.weight.uniform_(-0.1, 0.1, generator=g)
        if not model.tied:
            model.decoder.weight.uniform_(-0.1, 0.1, generator=g)
        model.decoder.bias.zero_()
        for i in range(nlayers):
            for _, name in LSTM_KEYS:
                getattr(model.rnn, name.format(i)).uniform_(
                    -bound, bound, generator=g)
    return model


def _model_from_arrays(arrays: Dict[str, np.ndarray], nlayers: int
                       ) -> RNNModel:
    """arrays: the JAX layout's leaves (embedding, decoder_b, decoder_w
    absent when tied, l{i}_{w_ih,w_hh,b_ih,b_hh})."""
    emb = arrays["embedding"]
    tied = arrays.get("decoder_w") is None
    nhid = arrays["l0_w_hh"].shape[1]
    model = RNNModel(emb.shape[0], emb.shape[1], nhid, nlayers, tied)
    sd = {"encoder.weight": emb, "decoder.bias": arrays["decoder_b"],
          "decoder.weight": emb if tied else arrays["decoder_w"]}
    for i in range(nlayers):
        for k, name in LSTM_KEYS:
            sd["rnn." + name.format(i)] = arrays[f"l{i}_{k}"]
    model.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                           for k, v in sd.items()})
    return model


def _load_npz_lm(path: str) -> Tuple[RNNModel, Dict[str, int]]:
    data = np.load(path, allow_pickle=True)
    meta = data["meta"].item()
    arrays = {k: data[k] for k in data.files if k != "meta"}
    return _model_from_arrays(arrays, meta["nlayers"]), meta["word2idx"]


def _load_torch_lm(path: str) -> Tuple[RNNModel, Dict[str, int]]:
    """A reference torch LM checkpoint (lstm_utils.py:52-64 layout:
    model_state_dict with encoder/rnn/decoder keys, word2idx, nlayers).
    Its decoder weight is read as its own leaf, as the JAX package
    reads it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.numpy() for k, v in ckpt["model_state_dict"].items()}
    nlayers = ckpt["nlayers"]
    arrays = {"embedding": sd["encoder.weight"],
              "decoder_w": sd["decoder.weight"],
              "decoder_b": sd["decoder.bias"]}
    for i in range(nlayers):
        for k, name in LSTM_KEYS:
            arrays[f"l{i}_{k}"] = sd["rnn." + name.format(i)]
    return _model_from_arrays(arrays, nlayers), ckpt["word2idx"]


def save_npz_lm(path: str, model: RNNModel, word2idx: Dict[str, int]
                ) -> None:
    """The JAX package's .npz layout; a tied model writes no decoder_w
    (the JAX package would read one as an untied decoder)."""
    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy()
    arrays = {"embedding": arr(model.encoder.weight),
              "decoder_b": arr(model.decoder.bias),
              "meta": np.array({"word2idx": dict(word2idx),
                                "nlayers": model.rnn.num_layers},
                               dtype=object)}
    if not model.tied:
        arrays["decoder_w"] = arr(model.decoder.weight)
    for i in range(model.rnn.num_layers):
        for k, name in LSTM_KEYS:
            arrays[f"l{i}_{k}"] = arr(getattr(model.rnn, name.format(i)))
    np.savez(path, **arrays)


class LM:
    """The rescoring LM (reference lstm_utils.LM): evaluate(seq_str) →
    (total_ce, oov). The model runs on `device` (the card unless told
    otherwise; TF32 off, evaluation.resolve_device)."""

    def __init__(self, model_path: str, device="cuda"):
        from end2end_asr_tpu_torch.evaluation import resolve_device
        self.device = resolve_device(str(device))
        if model_path.endswith((".pt", ".th")):
            model, self.word2idx = _load_torch_lm(model_path)
        else:
            model, self.word2idx = _load_npz_lm(model_path)
        self.model = model.to(self.device).eval()

    def seq_to_ids(self, seq: str) -> Tuple[np.ndarray, int]:
        """Word ids of seq + <eos>, and the count of words that fell to
        <oov>. A word missing from the vocabulary is looked up lowercased
        first: lm_train's corpus is lowercased (data/lm_loader.py)."""
        oov_id = self.word2idx.get("<oov>", 0)
        ids, oov = [], 0
        for w in seq.split() + ["<eos>"]:
            if w in self.word2idx:
                ids.append(self.word2idx[w])
            elif w.lower() in self.word2idx:
                ids.append(self.word2idx[w.lower()])
            else:
                ids.append(oov_id)
                oov += 1
        return np.asarray(ids, np.int64), oov

    @torch.inference_mode()
    def evaluate(self, seq: str) -> Tuple[float, int]:
        """Summed next-word cross-entropy over the sequence (each id
        predicted from the ones before it), and the OOV count; (0.0, oov)
        below 2 ids."""
        ids, oov = self.seq_to_ids(seq)
        if len(ids) < 2:
            return 0.0, oov
        x = torch.from_numpy(ids).to(self.device)
        logits = self.model(x[None, :-1])[0].to(torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        ll = logp.gather(1, x[1:, None])[:, 0]
        return float(-ll.sum()), oov
