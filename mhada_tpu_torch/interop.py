"""Weights from the JAX package's param trees and from reference ``.pth`` files.

The port's state_dict keys mirror the JAX tree's paths (``block0.attention
.out_proj.weight`` for ``block0/attention/out_proj/kernel``); only the leaf
layouts change to torch's: conv kernels HWIO -> OIHW, linear kernels
(in, out) -> (out, in), LayerNorm ``scale`` -> ``weight``.  The MHAda
kernel stacks and the position grid keep the JAX layouts.

A reference ``.pth`` triple is read with ``torch.load(weights_only=True)``
and mapped onto the JAX tree by this module's own copy of the JAX
package's importers (mhada_tpu/interop/torch_import.py:22-131: the ViT,
the MHAda block, the decoder and AdaFormer), then goes through the same
bridge.
"""

import numpy as np
import torch


def _leaf(name: str, value) -> tuple[str, np.ndarray]:
    a = np.asarray(value)
    if name == "kernel" and a.ndim == 4:
        return "weight", a.transpose(3, 2, 0, 1)
    if name == "kernel" and a.ndim == 2:
        return "weight", a.T
    if name == "qkv_kernel":
        return "qkv_weight", a.T
    if name == "scale":
        return "weight", a
    return name, a


def params_from_jax(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """One network's JAX param tree (nested dicts of arrays) -> state_dict."""
    sd = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            sd.update(params_from_jax(value, f"{prefix}{key}."))
        else:
            name, a = _leaf(key, value)
            sd[prefix + name] = torch.from_numpy(np.array(a, np.float32))
    return sd


def load_params(models: dict, state_dicts: dict) -> None:
    """Load {vit_c, vit_s, adaFormer} state_dicts into ``models`` (strict)."""
    for name, sd in state_dicts.items():
        models[name].load_state_dict(sd, strict=True)


def jax_params_to_state_dicts(params: dict) -> dict:
    """The JAX {vit_c, vit_s, adaFormer} params -> port state_dicts."""
    return {name: params_from_jax(tree) for name, tree in params.items()}


def _conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _lin(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def import_vit(sd: dict, num_layers: int = 3) -> dict:
    """Reference VisionTransformer state_dict -> JAX-layout tree
    (torch_import.py:22-60; reference vit.py:120-169)."""
    p = {"patch_embedding": {"proj": {
        "kernel": _conv(sd["patch_embedding.conv_proj.weight"]),
        "bias": sd["patch_embedding.conv_proj.bias"]}}}
    if "pos_embedding.pos_embed" in sd:
        p["pos_embedding"] = {"pos_embed": np.ascontiguousarray(
            sd["pos_embedding.pos_embed"].transpose(0, 2, 3, 1))}
    for i in range(num_layers):
        t = f"encoder.{i}."
        p[f"block{i}"] = {
            "ln1": {"scale": sd[t + "ln1.weight"], "bias": sd[t + "ln1.bias"]},
            "ln2": {"scale": sd[t + "ln2.weight"], "bias": sd[t + "ln2.bias"]},
            "attention": {
                "qkv_kernel": _lin(sd[t + "attention.in_proj_weight"]),
                "qkv_bias": sd[t + "attention.in_proj_bias"],
                "out_proj": {
                    "kernel": _lin(sd[t + "attention.out_proj.weight"]),
                    "bias": sd[t + "attention.out_proj.bias"]},
            },
            "mlp_fc1": {"kernel": _lin(sd[t + "mlp.0.weight"]),
                        "bias": sd[t + "mlp.0.bias"]},
            "mlp_fc2": {"kernel": _lin(sd[t + "mlp.2.weight"]),
                        "bias": sd[t + "mlp.2.bias"]},
        }
    return p


def _import_mhada_block(sd: dict, prefix: str, num_heads: int) -> dict:
    """One AdaAttnMultiHead: per-head 1x1 convs -> (heads, d, d) stacks
    (torch_import.py:77-98)."""

    def stack(name):
        ks = [sd[f"{prefix}{name}_list.{h}.weight"][:, :, 0, 0].T
              for h in range(num_heads)]
        bs = [sd[f"{prefix}{name}_list.{h}.bias"] for h in range(num_heads)]
        return np.stack(ks), np.stack(bs)

    p = {}
    for name in ("f", "g", "h"):
        p[f"{name}_kernel"], p[f"{name}_bias"] = stack(name)
    p["out_kernel"] = sd[f"{prefix}out_conv.weight"][:, :, 0, 0].T
    p["out_bias"] = sd[f"{prefix}out_conv.bias"]
    return p


_DECODER_MAP = {
    "up1": "conv1.0", "c1": "conv1.1", "c2": "conv1.2", "c3": "conv1.3",
    "up2": "conv1.4", "c4": "conv2.0", "up3": "conv2.1", "c5": "conv3.0",
    "c6": "conv3.1",
}


def import_decoder(sd: dict, prefix: str = "decoder.") -> dict:
    """Reference Decoder (conv.py:75-100) -> JAX-layout tree
    (torch_import.py:108-118)."""
    return {ours: {"conv": {
        "kernel": _conv(sd[f"{prefix}{theirs}.conv.conv.weight"]),
        "bias": sd[f"{prefix}{theirs}.conv.conv.bias"]}}
        for ours, theirs in _DECODER_MAP.items()}


def import_adaformer(sd: dict, num_layers: int = 3, num_heads: int = 8
                     ) -> dict:
    """Reference AdaAttnTransformerMultiHead state_dict -> JAX-layout tree
    (torch_import.py:121-129)."""
    p = {f"ada{j}": _import_mhada_block(sd, f"adaAttnHead.{j}.", num_heads)
         for j in range(2 * num_layers)}
    p["decoder"] = import_decoder(sd)
    return p


def load_pth(path: str) -> dict[str, np.ndarray]:
    """A reference ``.pth`` state_dict as float32 numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def load_pth_params(ada_path: str, vitc_path: str, vits_path: str,
                    num_layers: int = 3, num_heads: int = 8) -> dict:
    """A reference checkpoint triple (infer_image.py:55-57) -> port
    state_dicts {vit_c, vit_s, adaFormer}."""
    return jax_params_to_state_dicts({
        "vit_c": import_vit(load_pth(vitc_path), num_layers),
        "vit_s": import_vit(load_pth(vits_path), num_layers),
        "adaFormer": import_adaformer(load_pth(ada_path), num_layers,
                                      num_heads),
    })
