"""Checkpoint conversion CLI — the port of ``deepspeed_tpu/checkpoint_utils.py``.

Checkpoints hold full tensors under their tree paths (universal by
construction), so conversion is re-keying, not merging:

    python -m deepspeed_tpu_torch.checkpoint_utils fp32 <ckpt_dir> <out.safetensors>
    python -m deepspeed_tpu_torch.checkpoint_utils hf-llama <ckpt_dir> <out_dir> \\
        --num-layers N   # tied/untied embeddings auto-detected

``<ckpt_dir>`` is a tag directory, or a save directory whose ``latest``
names one.  ``fp32`` writes one consolidated f32 model file; ``hf-llama``
writes an HF-transformers LLaMA state dict (``model.safetensors``, in
the checkpoint's dtypes: the reference means to widen bf16 to f32, but
its test, ``dtype.kind == "f"``, is false for ml_dtypes' bfloat16, so its
files keep BF16, and so do the port's).  Both read and write safetensors with the
port's own reader and writer (the ``safetensors`` package is not needed),
tensors in that library's order, so the files equal the reference CLI's.

As in the reference, ``hf-llama`` builds the model config from the
defaults and ``--num-layers``: the rope permutation of q and k uses the
default 8 heads of 64 (``TransformerConfig()``), whatever the checkpoint's
width.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import torch

from .runtime.checkpoint.engine import (_LATEST, _ST_ORDER, _load_tree_flat)
from .utils.tree_io import host_array


def _load_model_tensors(ckpt_dir: str) -> Dict[str, torch.Tensor]:
    if os.path.exists(os.path.join(ckpt_dir, _LATEST)):
        with open(os.path.join(ckpt_dir, _LATEST)) as f:
            ckpt_dir = os.path.join(ckpt_dir, f.read().strip())
    path = os.path.join(ckpt_dir, "model.safetensors")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no model.safetensors under {ckpt_dir}")
    return _load_tree_flat(path)


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """A safetensors file as the library's ``save_file`` writes it: no
    metadata, tensors by dtype (widest first) then by name."""
    from .io.fast_writer import header_from_host

    hosts = {k: host_array(t.contiguous()) for k, t in tensors.items()}
    order = sorted(hosts, key=lambda k: (_ST_ORDER.index(hosts[k][1]), k))
    hosts = {k: hosts[k] for k in order}
    header, _, _ = header_from_host(hosts, None)
    with open(path, "wb") as f:
        f.write(header)
        for arr, _ in hosts.values():
            f.write(arr.tobytes())


def to_fp32(ckpt_dir: str, out_path: str) -> None:
    flat = _load_model_tensors(ckpt_dir)
    fp32 = {k: v.float() for k, v in flat.items()}
    save_file(fp32, out_path)
    total = sum(v.numel() for v in fp32.values())
    print(f"wrote {out_path}: {len(fp32)} tensors, {total / 1e6:.1f}M "
          "params fp32")


def _rope_permute(w_t: torch.Tensor, n_heads: int, head_dim: int
                  ) -> torch.Tensor:
    """The reference's ``_rope_permute``: interleaved rope pairs of each
    head's output columns -> HF's half split."""
    d_in = w_t.shape[0]
    w = w_t.reshape(d_in, n_heads, head_dim // 2, 2).transpose(-1, -2)
    return w.reshape(d_in, n_heads * head_dim)


def params_to_hf_llama(flat: Dict[str, torch.Tensor], num_layers: int,
                       tie_embeddings: bool, num_heads: int = 8,
                       kv_heads: int = 8, head_dim: int = 64
                       ) -> Dict[str, torch.Tensor]:
    """The reference's ``models/hf_integration.params_to_hf_llama`` on a
    flat checkpoint tree (HF Linear weights are (out, in))."""
    out = {"model.embed_tokens.weight": flat["embed/tokens"],
           "model.norm.weight": flat["final_norm/scale"]}
    for i in range(num_layers):
        pre = f"model.layers.{i}"

        def w(name):
            return flat[f"layers/{name}"][i]

        out[f"{pre}.self_attn.q_proj.weight"] = _rope_permute(
            w("attn/wq"), num_heads, head_dim).T
        out[f"{pre}.self_attn.k_proj.weight"] = _rope_permute(
            w("attn/wk"), kv_heads, head_dim).T
        out[f"{pre}.self_attn.v_proj.weight"] = w("attn/wv").T
        out[f"{pre}.self_attn.o_proj.weight"] = w("attn/wo").T
        out[f"{pre}.mlp.gate_proj.weight"] = w("mlp/w_gate").T
        out[f"{pre}.mlp.up_proj.weight"] = w("mlp/w_in").T
        out[f"{pre}.mlp.down_proj.weight"] = w("mlp/w_out").T
        out[f"{pre}.input_layernorm.weight"] = w("ln1/scale")
        out[f"{pre}.post_attention_layernorm.weight"] = w("ln2/scale")
    if not tie_embeddings and "lm_head/w" in flat:
        out["lm_head.weight"] = flat["lm_head/w"].T
    return out


def to_hf_llama(ckpt_dir: str, out_dir: str, num_layers: int) -> None:
    from .models.transformer import TransformerConfig

    flat = _load_model_tensors(ckpt_dir)
    # tied embeddings are a property of the checkpoint: untied models carry
    # an lm_head tensor
    tie_embeddings = not any(k.startswith("lm_head") for k in flat)
    cfg = TransformerConfig(num_layers=num_layers,
                            tie_embeddings=tie_embeddings)
    sd = params_to_hf_llama(flat, num_layers, tie_embeddings, cfg.num_heads,
                            cfg.kv_heads, cfg.head_dim)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "model.safetensors")
    save_file(sd, out)
    print(f"wrote {out}: {len(sd)} tensors (HF LLaMA layout)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="deepspeed_tpu_torch.checkpoint_utils")
    sub = p.add_subparsers(dest="cmd", required=True)
    f32 = sub.add_parser("fp32", help="consolidated fp32 safetensors")
    f32.add_argument("ckpt_dir")
    f32.add_argument("out_path")
    hf = sub.add_parser("hf-llama", help="HF LLaMA state dict")
    hf.add_argument("ckpt_dir")
    hf.add_argument("out_dir")
    hf.add_argument("--num-layers", type=int, required=True)
    args = p.parse_args(argv)
    if args.cmd == "fp32":
        to_fp32(args.ckpt_dir, args.out_path)
    else:
        to_hf_llama(args.ckpt_dir, args.out_dir, args.num_layers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
