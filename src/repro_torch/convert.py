"""Carry CKKS state between the JAX package and the port, as numpy arrays.

Functions here take and return numpy arrays and plain numbers
(``serving_to_dicts`` takes a dataclass of either package's serving
layer); none imports the JAX package, so the port still imports nothing
of it.
Residues cross as uint64 (the JAX package's dtype) and live in the port
as int64.  LM parameters, decode caches and AdamW states cross as
nested dicts and lists of numpy arrays (the JAX package's pytrees);
bf16 arrays arrive with numpy's ``bfloat16`` extension dtype and are
reinterpreted bit for bit, and leave as float32 (exact).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ckks import Ciphertext, Plaintext
from repro_torch.core.keys import EvalKey, KeyChain
from repro_torch.core.poly import PolyContext, resolve_device
from repro_torch.models.model import layer_pattern
from repro_torch.train.tree import tree_map
from repro_torch.workloads.models import (
    Activation, Dense, Workload, scaled_tanh, sigmoid4,
)


def _tensor(pc: PolyContext, arr) -> "object":
    return pc.tensor(np.asarray(arr).astype(np.int64))


def _numpy(t) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint64)


def evk_from_numpy(pc: PolyContext, stack) -> EvalKey:
    """(dnum, 2, L+1+k, N) digit stack -> EvalKey."""
    return EvalKey(digits=[_tensor(pc, d) for d in np.asarray(stack)])


def evk_to_numpy(evk: EvalKey) -> np.ndarray:
    return np.stack([_numpy(d) for d in evk.digits])


def keychain_from_numpy(pc: PolyContext, s_coeffs, *, mult_key=None,
                        rot_keys: dict | None = None, conj_key=None,
                        seed: int = 0) -> KeyChain:
    """A KeyChain on ``pc`` with the given secret and evk digit stacks.

    Keys not given are generated on demand from ``default_rng(seed)``."""
    chain = KeyChain.from_secret(pc.params, pc, np.asarray(s_coeffs),
                                 np.random.default_rng(seed))
    if mult_key is not None:
        chain._mult_key = evk_from_numpy(pc, mult_key)
    if conj_key is not None:
        chain._conj_key = evk_from_numpy(pc, conj_key)
    for steps, stack in (rot_keys or {}).items():
        chain._rot_keys[steps % pc.params.num_slots] = evk_from_numpy(
            pc, stack)
    return chain


def keychain_to_numpy(chain: KeyChain) -> dict:
    """The secret and every generated evk, as numpy arrays."""
    out = {"s_coeffs": chain.s_coeffs.copy(),
           "rot_keys": {s: evk_to_numpy(k)
                        for s, k in chain._rot_keys.items()}}
    if chain._mult_key is not None:
        out["mult_key"] = evk_to_numpy(chain._mult_key)
    if chain._conj_key is not None:
        out["conj_key"] = evk_to_numpy(chain._conj_key)
    return out


def ciphertext_from_numpy(pc: PolyContext, c0, c1, level: int,
                          scale: float) -> Ciphertext:
    return Ciphertext(_tensor(pc, c0), _tensor(pc, c1), int(level),
                      float(scale))


def ciphertext_to_numpy(ct: Ciphertext) -> dict:
    return {"c0": _numpy(ct.c0), "c1": _numpy(ct.c1), "level": ct.level,
            "scale": ct.scale}


def plaintext_from_numpy(pc: PolyContext, m, level: int,
                         scale: float) -> Plaintext:
    return Plaintext(_tensor(pc, m), int(level), float(scale))


def plaintext_to_numpy(pt: Plaintext) -> dict:
    return {"m": _numpy(pt.m), "level": pt.level, "scale": pt.scale}


def exec_result_to_numpy(result) -> dict:
    """A ``ProgramExecutor`` result's outputs as numpy: each tag maps to
    ``ciphertext_to_numpy`` of its ciphertext, or to a list of them, one
    per batch slot, for ``run_batched``."""
    return {tag: ([ciphertext_to_numpy(c) for c in ct]
                  if isinstance(ct, list) else ciphertext_to_numpy(ct))
            for tag, ct in result.outputs.items()}


def activation_from_numpy(name: str, degree: int, coeffs) -> Activation:
    """The port's activation of that name (``sigmoid4`` or ``tanh*s``)
    with the given Chebyshev coefficients."""
    if name == "sigmoid4":
        fn = sigmoid4(degree).fn
    elif name.startswith("tanh*"):
        fn = scaled_tanh(float(name[len("tanh*"):]), degree).fn
    else:
        raise ValueError(f"unknown activation {name!r}")
    return Activation(name, fn, int(degree),
                      np.asarray(coeffs, dtype=np.float64))


def dense_from_numpy(name: str, diags: dict, bias=None, act=None,
                     bs: int = 4) -> Dense:
    """A port ``Dense`` from its diagonals (offset -> array), bias and
    activation (``None`` or a dict of ``name``, ``degree``, ``coeffs``)."""
    return Dense(name, {int(d): np.asarray(v, dtype=np.float64)
                        for d, v in diags.items()},
                 bias=None if bias is None else np.asarray(bias),
                 act=None if act is None else activation_from_numpy(**act),
                 bs=int(bs))


def workload_from_numpy(name: str, layers: list[dict],
                        input_mag: float = 1.0,
                        tolerance: float = 5e-3) -> Workload:
    """A port ``Workload`` from ``dense_from_numpy`` keyword dicts."""
    return Workload(name, [dense_from_numpy(**layer) for layer in layers],
                    input_mag=float(input_mag), tolerance=float(tolerance))


def serving_to_dicts(obj):
    """A ``ServingReport`` as a dict of its fields, or a ``BatchRecord``
    log as a list of them, for a field-by-field comparison of two
    servers."""
    if isinstance(obj, (list, tuple)):
        return [dataclasses.asdict(r) for r in obj]
    return dataclasses.asdict(obj)


# ------------------------------ LM zoo ------------------------------------

def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, order="C")   # a writable copy
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 extension type: same bits as torch.bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def lm_params_from_numpy(cfg, tree, device="cuda") -> dict:
    """The JAX package's ``init_params(cfg)`` pytree, as numpy arrays ->
    the port's parameters on ``device``.

    Each leaf keeps its own dtype: bf16 stays bf16 (bit for bit) and
    float32 stays float32, as the reference keeps some leaves float32
    under a bf16 config (the MoE router, Mamba's ``dt_bias``, ``A_log``
    and ``D``, the mLSTM's ``wif``).  Both packages keep the same
    pytree: ``blocks[s][...][r]`` is layer ``r * len(pattern) + s``, and
    an encoder-decoder's ``encoder`` and ``cross`` are lists, one entry
    a layer."""
    device = resolve_device(device)
    pattern, reps = layer_pattern(cfg)
    if len(tree["blocks"]) != len(pattern):
        raise ValueError(f"{cfg.name}: {len(tree['blocks'])} block slots, "
                         f"the pattern has {len(pattern)}")
    out = tree_map(lambda a: _leaf_from_numpy(a, device), tree)
    for slot in out["blocks"]:
        tree_map(lambda t: _check_reps(t, reps, cfg), slot)
    return out


def _check_reps(t, reps: int, cfg) -> None:
    if t.shape[0] != reps:
        raise ValueError(f"{cfg.name}: a block leaf of shape "
                         f"{tuple(t.shape)} does not stack {reps} layers")


def lm_params_to_numpy(params) -> dict:
    """The port's parameters as numpy (bf16 as float32)."""
    return tree_map(_leaf_to_numpy, params)


def lm_cache_from_numpy(cfg, cache, device="cuda") -> dict:
    """The JAX package's decode cache (``init_cache`` or a decode step's
    output), as numpy arrays -> the port's, on ``device``, each leaf in
    its own dtype (the float32 states ``ssm``, ``C``, ``n`` and the
    sLSTM's ``c`` stay float32), with ``idx`` as an int."""
    device = resolve_device(device)
    return {"slots": tree_map(lambda a: _leaf_from_numpy(a, device),
                               cache["slots"]),
            "idx": int(np.asarray(cache["idx"]))}


def lm_cache_to_numpy(cache) -> dict:
    """The port's decode cache as numpy (bf16 as float32, ``idx`` an
    int32 scalar array, as the JAX package keeps it)."""
    return {"slots": tree_map(_leaf_to_numpy, cache["slots"]),
            "idx": np.asarray(cache["idx"], dtype=np.int32)}


def lm_opt_state_from_numpy(state, device="cuda") -> dict:
    """The JAX package's AdamW state (``m`` and ``v`` trees and the
    int32 ``step``), as numpy arrays -> the port's, on ``device``, each
    leaf in its own dtype (bf16 moments stay bf16, bit for bit) and
    ``step`` an int32 scalar tensor."""
    device = resolve_device(device)
    return {"m": tree_map(lambda a: _leaf_from_numpy(a, device),
                           state["m"]),
            "v": tree_map(lambda a: _leaf_from_numpy(a, device),
                           state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def lm_opt_state_to_numpy(state) -> dict:
    """The port's AdamW state as numpy (bf16 moments as float32, exact;
    ``step`` an int32 scalar array, as the JAX package keeps it)."""
    return {"m": tree_map(_leaf_to_numpy, state["m"]),
            "v": tree_map(_leaf_to_numpy, state["v"]),
            "step": np.asarray(int(state["step"]), dtype=np.int32)}
