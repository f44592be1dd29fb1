"""Weights from the JAX package's param trees and from reference ``.pth`` files.

The port's state_dict keys mirror the JAX tree's paths (``block0.attention
.out_proj.weight`` for ``block0/attention/out_proj/kernel``); only the leaf
layouts change to torch's: conv kernels HWIO -> OIHW, linear kernels
(in, out) -> (out, in), LayerNorm ``scale`` -> ``weight``.  The MHAda
kernel stacks and the position grid keep the JAX layouts.

A reference ``.pth`` triple is read with ``torch.load(weights_only=True)``
and mapped onto the JAX tree by this module's own copy of the JAX
package's importers (mhada_tpu/interop/torch_import.py:22-176: the ViT and
its multi-scale variant, the MHAda block, the decoder, AdaFormer, the
single-head AdaAttnTransformer and torchvision's VGG19), then goes
through the same bridge.  The way back, port modules -> reference-format
state_dicts, is its copy of the exporters (torch_export.py:23-98).
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


def import_vit_multiscale(sd: dict, num_layers: int = 3) -> dict:
    """Reference VisionTransformerMultiScale state_dict (vit.py:172-236) ->
    JAX-layout tree: the ViT's plus the stride-2 re-patch embeddings
    (torch_import.py:63-75)."""
    p = import_vit(sd, num_layers)
    for i in range(num_layers - 1):
        p[f"repatch{i}"] = {"proj": {
            "kernel": _conv(sd[f"repatch.{i}.conv_proj.weight"]),
            "bias": sd[f"repatch.{i}.conv_proj.bias"]}}
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


def import_adaattn_transformer(sd: dict, num_layers: int = 3) -> dict:
    """Reference single-head AdaAttnTransformer (adaDecoder.py:209-232) ->
    JAX-layout tree (torch_import.py:132-155): 1x1 convs -> (in, out)."""
    p = {}
    for j in range(num_layers):
        t = f"adaAttNs.{j}."
        p[f"ada{j}"] = {}
        for name in ("f", "g", "h"):
            p[f"ada{j}"][f"{name}_kernel"] = sd[t + name + ".weight"][
                :, :, 0, 0].T
            p[f"ada{j}"][f"{name}_bias"] = sd[t + name + ".bias"]
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


# torchvision VGG19 ``features`` indices of the convs up to conv5_1
# (mhada_tpu/interop/torch_import.py:149-154).
_VGG19_IDX = {
    "conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7,
    "conv3_1": 10, "conv3_2": 12, "conv3_3": 14, "conv3_4": 16,
    "conv4_1": 19, "conv4_2": 21, "conv4_3": 23, "conv4_4": 25,
    "conv5_1": 28,
}


def import_vgg19(sd: dict) -> dict:
    """torchvision VGG19 ``features.*`` weights, or the reference VGG19's
    ``sliceN.*`` naming (reference vgg19.py:20-44), -> the JAX-layout tree
    of ``VGG19Features`` (torch_import.py:157-176); ``params_from_jax``
    turns it into the port's state_dict."""
    if any(k.startswith("slice") for k in sd):
        sd = {f"features.{k.split('.')[1]}.{k.split('.')[2]}": v
              for k, v in sd.items() if k.startswith("slice")}
    p = {}
    for name, idx in _VGG19_IDX.items():
        key = f"features.{idx}.weight"
        if key not in sd:
            raise KeyError(f"missing VGG19 weight {key}")
        p[name] = {"kernel": _conv(np.asarray(sd[key])),
                   "bias": np.asarray(sd[f"features.{idx}.bias"])}
    return p


def load_vgg19(path: str) -> dict[str, torch.Tensor]:
    """A torchvision VGG19 ``.pth`` -> the state_dict of ``VGG19Features``."""
    return params_from_jax(import_vgg19(load_pth(path)))


def state_dict_to_jax(sd: dict) -> dict:
    """The inverse of ``params_from_jax``: a port state_dict -> one
    network's JAX-layout tree of float32 numpy arrays."""
    tree = {}
    for key, value in sd.items():
        *path, name = key.split(".")
        a = value.detach().cpu().float().numpy()
        if name == "weight" and a.ndim == 4:
            name, a = "kernel", a.transpose(2, 3, 1, 0)
        elif name == "weight" and a.ndim == 2:
            name, a = "kernel", a.T
        elif name == "qkv_weight":
            name, a = "qkv_kernel", a.T
        elif name == "weight" and path[-1].startswith("ln"):
            name = "scale"
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(a)
    return tree


def _conv_out(k: np.ndarray) -> np.ndarray:
    """HWIO -> torch OIHW."""
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


def export_vit(p: dict, num_layers: int = 3) -> dict[str, np.ndarray]:
    """A ViT's JAX-layout tree -> the reference state_dict
    (mhada_tpu/interop/torch_export.py:23-55)."""
    sd = {"patch_embedding.conv_proj.weight":
          _conv_out(p["patch_embedding"]["proj"]["kernel"]),
          "patch_embedding.conv_proj.bias":
          p["patch_embedding"]["proj"]["bias"]}
    if "pos_embedding" in p:
        sd["pos_embedding.pos_embed"] = np.ascontiguousarray(
            p["pos_embedding"]["pos_embed"].transpose(0, 3, 1, 2))
    for i in range(num_layers):
        b, t = p[f"block{i}"], f"encoder.{i}."
        sd[t + "ln1.weight"] = b["ln1"]["scale"]
        sd[t + "ln1.bias"] = b["ln1"]["bias"]
        sd[t + "ln2.weight"] = b["ln2"]["scale"]
        sd[t + "ln2.bias"] = b["ln2"]["bias"]
        sd[t + "attention.in_proj_weight"] = _lin(b["attention"]["qkv_kernel"])
        sd[t + "attention.in_proj_bias"] = b["attention"]["qkv_bias"]
        sd[t + "attention.out_proj.weight"] = _lin(
            b["attention"]["out_proj"]["kernel"])
        sd[t + "attention.out_proj.bias"] = b["attention"]["out_proj"]["bias"]
        sd[t + "mlp.0.weight"] = _lin(b["mlp_fc1"]["kernel"])
        sd[t + "mlp.0.bias"] = b["mlp_fc1"]["bias"]
        sd[t + "mlp.2.weight"] = _lin(b["mlp_fc2"]["kernel"])
        sd[t + "mlp.2.bias"] = b["mlp_fc2"]["bias"]
    return sd


def export_adaformer(p: dict, num_layers: int = 3,
                     num_heads: int = 8) -> dict[str, np.ndarray]:
    """AdaFormer's JAX-layout tree -> the reference state_dict
    (torch_export.py:58-97): per-head 1x1 convs and the decoder."""
    sd = {}
    for j in range(2 * num_layers):
        b, t = p[f"ada{j}"], f"adaAttnHead.{j}."
        for name in ("f", "g", "h"):
            for h in range(num_heads):
                sd[f"{t}{name}_list.{h}.weight"] = np.ascontiguousarray(
                    b[f"{name}_kernel"][h].T[:, :, None, None])
                sd[f"{t}{name}_list.{h}.bias"] = b[f"{name}_bias"][h]
        sd[t + "out_conv.weight"] = np.ascontiguousarray(
            b["out_kernel"].T[:, :, None, None])
        sd[t + "out_conv.bias"] = b["out_bias"]
    for ours, theirs in _DECODER_MAP.items():
        conv = p["decoder"][ours]["conv"]
        sd[f"decoder.{theirs}.conv.conv.weight"] = _conv_out(conv["kernel"])
        sd[f"decoder.{theirs}.conv.conv.bias"] = conv["bias"]
    return sd


def export_state_dicts(models: dict, num_layers: int = 3,
                       num_heads: int = 8) -> dict[str, dict]:
    """{vit_c, vit_s, adaFormer} modules -> reference-format state_dicts of
    tensors, as the reference saves them."""

    def tensors(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}

    return {
        "vit_c": tensors(export_vit(
            state_dict_to_jax(models["vit_c"].state_dict()), num_layers)),
        "vit_s": tensors(export_vit(
            state_dict_to_jax(models["vit_s"].state_dict()), num_layers)),
        "adaFormer": tensors(export_adaformer(
            state_dict_to_jax(models["adaFormer"].state_dict()), num_layers,
            num_heads)),
    }
