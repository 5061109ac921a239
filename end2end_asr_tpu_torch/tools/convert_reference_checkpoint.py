"""Convert a reference torch checkpoint (.th) into the npz/json checkpoint
that both packages load (the port's copy of root
``tools/convert_reference_checkpoint.py``), so trained reference models
evaluate, and resume training, in the port.

    python -m end2end_asr_tpu_torch.tools.convert_reference_checkpoint \\
        in.th out_base [--device cpu]

Reference checkpoint layout (utils/functions.py:11-59): a dict with
label2id / id2label, the argparse namespace under 'args', epoch,
model_state_dict, the optimizer's state and Noam scalars, metrics. It is
read with ``torch.load(weights_only=True)``, argparse.Namespace allowed.

State-dict name mapping (reference module tree → the param pytree):

  encoder.input_linear.weight (D,I)        → encoder.input_linear.w (I,D)ᵀ
  encoder.layer_norm_input.{weight,bias}   → encoder.ln_input.{scale,bias}
  encoder.layers.N.self_attn.query_linear.*→ encoder.layers[N].self_attn.q.*
     (same for key/value/output linears; torch Linear weights transpose)
  *.self_attn.layer_norm.*                 → *.self_attn.ln.*
  *.pos_ffn.conv_1.weight (H,D,1)          → *.ffn.w1.w (D,H) squeeze+ᵀ
  *.pos_ffn.conv_2.weight (D,H,1)          → *.ffn.w2.w (H,D) squeeze+ᵀ
  decoder.trg_embedding.weight             → decoder.embedding
  decoder.output_linear.weight (V,D)       → decoder.output_linear.w (D,V)ᵀ
  conv.K.weight (O,I,kh,kw)  [frontend]    → frontend.convM.w (kh,kw,I,O)
  conv.K.{running_mean,running_var}        → state.frontend.bnM.{mean,var}

The Noam step (optimizer_params._step) goes into metrics["noam_step"],
from which `train --continue-from` restarts the schedule; Adam's moments
are not converted. The tensors are moved to `--device` (default the card)
and rearranged there.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import torch

from end2end_asr_tpu_torch.models.layers import sinusoid_table


def _t(t, device) -> torch.Tensor:
    return t.detach().to(device, torch.float32)


def _linear(sd, name, device) -> Dict[str, torch.Tensor]:
    p = {"w": _t(sd[f"{name}.weight"], device).t()}
    if f"{name}.bias" in sd:
        p["b"] = _t(sd[f"{name}.bias"], device)
    return p


def _ln(sd, name, device) -> Dict[str, torch.Tensor]:
    return {"scale": _t(sd[f"{name}.weight"], device),
            "bias": _t(sd[f"{name}.bias"], device)}


def _mha(sd, base, device) -> Dict:
    return {"q": _linear(sd, f"{base}.query_linear", device),
            "k": _linear(sd, f"{base}.key_linear", device),
            "v": _linear(sd, f"{base}.value_linear", device),
            "out": _linear(sd, f"{base}.output_linear", device),
            "ln": _ln(sd, f"{base}.layer_norm", device)}


def _ffn(sd, base, device) -> Dict:
    w1 = _t(sd[f"{base}.conv_1.weight"], device)[:, :, 0].t()  # (D,H)
    w2 = _t(sd[f"{base}.conv_2.weight"], device)[:, :, 0].t()  # (H,D)
    return {"w1": {"w": w1, "b": _t(sd[f"{base}.conv_1.bias"], device)},
            "w2": {"w": w2, "b": _t(sd[f"{base}.conv_2.bias"], device)},
            "ln": _ln(sd, f"{base}.layer_norm", device)}


def _conv2d(sd, name, device) -> Dict[str, torch.Tensor]:
    w = _t(sd[f"{name}.weight"], device)  # (O, I, kh, kw)
    return {"w": w.permute(2, 3, 1, 0),  # HWIO
            "b": _t(sd[f"{name}.bias"], device)}


def _bn(sd, name, device) -> Tuple[Dict, Dict]:
    params = {"scale": _t(sd[f"{name}.weight"], device),
              "bias": _t(sd[f"{name}.bias"], device)}
    state = {"mean": _t(sd[f"{name}.running_mean"], device),
             "var": _t(sd[f"{name}.running_var"], device)}
    return params, state


def convert_state_dict(sd: Dict, num_layers: int, feat_extractor: str,
                       emb_trg_sharing: bool, dim_model: int,
                       src_max_len: int, tgt_max_len: int, device="cpu"):
    """(params, model_state) pytrees of f32 tensors on `device`, shaped
    as `models.transformer.init_params` / `init_state` make them."""
    sd = {k.replace("module.", "", 1) if k.startswith("module.") else k: v
          for k, v in sd.items()}  # unwrap nn.DataParallel
    encoder = {
        "input_linear": _linear(sd, "encoder.input_linear", device),
        "ln_input": _ln(sd, "encoder.layer_norm_input", device),
        "layers": [
            {"self_attn": _mha(sd, f"encoder.layers.{i}.self_attn", device),
             "ffn": _ffn(sd, f"encoder.layers.{i}.pos_ffn", device)}
            for i in range(num_layers)],
        "pe": sinusoid_table(src_max_len, dim_model).to(device),
    }
    decoder = {
        "embedding": _t(sd["decoder.trg_embedding.weight"], device),
        "layers": [
            {"self_attn": _mha(sd, f"decoder.layers.{i}.self_attn", device),
             "enc_attn": _mha(sd, f"decoder.layers.{i}.encoder_attn",
                              device),
             "ffn": _ffn(sd, f"decoder.layers.{i}.pos_ffn", device)}
            for i in range(num_layers)],
        "pe": sinusoid_table(tgt_max_len + 1, dim_model).to(device),
    }
    if not emb_trg_sharing:
        decoder["output_linear"] = {
            "w": _t(sd["decoder.output_linear.weight"], device).t()}
    params = {"encoder": encoder, "decoder": decoder}
    model_state: Dict = {}
    if feat_extractor == "vgg_cnn":
        # nn.Sequential indices: 0,2 convs → pool → 5,7 convs → pool
        params["frontend"] = {"conv1": _conv2d(sd, "conv.0", device),
                              "conv2": _conv2d(sd, "conv.2", device),
                              "conv3": _conv2d(sd, "conv.5", device),
                              "conv4": _conv2d(sd, "conv.7", device)}
    elif feat_extractor == "emb_cnn":
        bn1_p, bn1_s = _bn(sd, "conv.1", device)
        bn2_p, bn2_s = _bn(sd, "conv.4", device)
        params["frontend"] = {"conv1": _conv2d(sd, "conv.0", device),
                              "bn1": bn1_p,
                              "conv2": _conv2d(sd, "conv.3", device),
                              "bn2": bn2_p}
        model_state["frontend"] = {"bn1": bn1_s, "bn2": bn2_s}
    return params, model_state


def convert_file(in_path: str, out_base: str, device="cpu") -> None:
    from end2end_asr_tpu_torch.config import Config
    from end2end_asr_tpu_torch.training.checkpoint import save_checkpoint

    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(in_path, map_location="cpu", weights_only=True)
    ns = ckpt["args"]
    cfg = Config.from_dict(vars(ns) if not isinstance(ns, dict) else ns)
    params, model_state = convert_state_dict(
        ckpt["model_state_dict"], cfg.num_layers, cfg.feat_extractor,
        cfg.emb_trg_sharing, cfg.dim_model, cfg.src_max_len,
        cfg.tgt_max_len, device)
    # carry the Noam step forward so a resumed run continues the schedule
    # (functions.py:86-91)
    metrics = dict(ckpt.get("metrics") or {})
    opt_params = ckpt.get("optimizer_params") or {}
    if "_step" in opt_params:
        metrics["noam_step"] = int(opt_params["_step"])
    save_checkpoint(out_base, cfg, int(ckpt.get("epoch", 0)), params,
                    ckpt["label2id"], ckpt["id2label"],
                    model_state=model_state, metrics=metrics)
    print(f"converted {in_path} -> {out_base}.npz/.json")


def main(argv: Optional[List[str]] = None) -> str:
    """Converts and returns the output base path."""
    from end2end_asr_tpu_torch.evaluation import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("th", help="the reference checkpoint (.th)")
    ap.add_argument("out", help="output checkpoint base path (no ext)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    convert_file(args.th, args.out, resolve_device(args.device))
    return args.out


if __name__ == "__main__":
    main(sys.argv[1:])
