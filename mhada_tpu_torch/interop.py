"""Weights from the JAX package's param trees and from reference ``.pth`` files.

The port's state_dict keys mirror the JAX tree's paths (``block0.attention
.out_proj.weight`` for ``block0/attention/out_proj/kernel``); only the leaf
layouts change to torch's: conv kernels HWIO -> OIHW, linear kernels
(in, out) -> (out, in), LayerNorm ``scale`` -> ``weight``.  The MHAda
kernel stacks and the position grid keep the JAX layouts.

A reference ``.pth`` triple goes through the JAX package's numpy-only
readers (mhada_tpu.interop: load_pth, import_vit, import_adaformer) and
then the same bridge.
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


def load_pth_params(ada_path: str, vitc_path: str, vits_path: str,
                    num_layers: int = 3, num_heads: int = 8) -> dict:
    """A reference checkpoint triple (infer_image.py:55-57) -> port
    state_dicts {vit_c, vit_s, adaFormer}."""
    from mhada_tpu.interop import import_adaformer, import_vit, load_pth

    return jax_params_to_state_dicts({
        "vit_c": import_vit(load_pth(vitc_path), num_layers),
        "vit_s": import_vit(load_pth(vits_path), num_layers),
        "adaFormer": import_adaformer(load_pth(ada_path), num_layers,
                                      num_heads),
    })
