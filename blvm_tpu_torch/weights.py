"""Parameter bridge between JAX (flax) parameter trees and the port's modules.

The port's modules carry the flax names as attribute names
(``res_stack.Conv1dResidualGLU_0.gate_kernel_t`` <-> flax
``res_stack/Conv1dResidualGLU_0/gate_kernel_t``) and the flax layouts (WIO conv
kernels, ``(in, out)`` Dense kernels), so moving parameters is renaming, never
transposing. A tree is a nested dict of arrays, or a flat dict keyed
``"a/b/c"`` as ``tests/parity/goldens/*.npz`` stores it.
"""

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested or flat ``"a/b/c"``-keyed dict -> flat dict."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten(value, path))
        else:
            flat[path] = value
    return flat


def unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat ``"a/b/c"``-keyed dict -> nested dict."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _flax_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def param_shapes(model: nn.Module) -> Dict[str, tuple]:
    """Flax name -> shape of every parameter of ``model``."""
    return {name: tuple(p.shape) for name, p in _flax_params(model).items()}


def load_jax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a JAX parameter tree into ``model`` in place; returns ``model``.

    Raises ``KeyError`` on a missing or an extra name and ``ValueError`` on a
    shape that differs, before anything is copied.
    """
    flat = flatten(tree)
    params = _flax_params(model)
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, unexpected {extra}")
    wrong = {n: (np.shape(flat[n]), tuple(p.shape)) for n, p in params.items() if np.shape(flat[n]) != tuple(p.shape)}
    if wrong:
        raise ValueError(f"parameter shapes differ (given, expected): {wrong}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.as_tensor(np.asarray(flat[name]), dtype=p.dtype))
    return model


def export_jax_params(model: nn.Module) -> dict:
    """The model's parameters as a nested flax-named dict of float32 numpy arrays."""
    return unflatten({name: p.detach().to("cpu", torch.float32).numpy() for name, p in _flax_params(model).items()})


# a recurrent core's parameter names: w_ih, b_ih, w_hh, b_hh, each with an optional _{layer}
_RECURRENT = re.compile(r"[wb]_(?:ih|hh)(_\d+)?")


def _orthogonal_rows(rng: np.random.Generator, shape) -> np.ndarray:
    """``jax.nn.initializers.orthogonal()`` for an ``(H, 3H)`` kernel: the QR of a normal
    ``(3H, H)`` draw, Q's columns signed by diag(R), transposed, so ``W W^T = I_H``."""
    rows, cols = shape
    q, r = np.linalg.qr(rng.standard_normal((cols, rows)))
    return (q * np.sign(np.diag(r))).T


def random_jax_params(model: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """Flax-layout parameters for ``model`` drawn with numpy from ``seed``:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the torch-calibrated init both packages
    use. A kernel's fan-in is the product of all but its output dim; a bias
    takes its kernel's (``bias`` -> ``kernel``, ``gate_bias_t`` -> ``gate_kernel_t``).
    A recurrent core's parameters (``w_ih``, ``b_ih``, ``w_hh``, ``b_hh``, with or
    without a ``_{layer}`` suffix) all take U(-1/sqrt(H), 1/sqrt(H)), H the rows of
    the sibling ``w_hh`` (``blvm_tpu/modules/recurrent.py:32-38``), except the ``w_hh``
    of a module with ``orthogonal_hh`` set (the VRNN's ``GRUCell``), which is orthogonal
    as flax draws it (``blvm_tpu/modules/recurrent.py:132``). As flax initializes them, a
    ``GroupNorm_*`` module's ``scale`` is ones and its ``bias`` zeros, and a depthwise conv's
    ``depthwise_bias`` is zeros (``blvm_tpu/models/clockwork_vae/conv_coders.py:74``); its
    ``depthwise_kernel (k, 1, C)`` takes fan-in ``k``."""
    rng = np.random.default_rng(seed)
    shapes = param_shapes(model)
    orthogonal = {f"{name.replace('.', '/')}/w_hh" for name, m in model.named_modules()
                  if getattr(m, "orthogonal_hh", False)}
    out = {}
    for name, shape in shapes.items():
        if name in orthogonal:
            out[name] = _orthogonal_rows(rng, shape).astype(np.float32)
            continue
        *parents, leaf = name.split("/")
        if (parents and parents[-1].startswith("GroupNorm")) or leaf == "depthwise_bias":
            out[name] = (np.ones if leaf == "scale" else np.zeros)(shape, np.float32)
            continue
        recurrent = _RECURRENT.fullmatch(leaf)
        if recurrent:
            fan_in = shapes["/".join([*parents, f"w_hh{recurrent.group(1) or ''}"])][0]
        else:
            kernel = "/".join([*parents, leaf.replace("bias", "kernel")])
            fan_in = int(np.prod(shapes[kernel][:-1]))
        bound = 1.0 / np.sqrt(fan_in)
        out[name] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return out
