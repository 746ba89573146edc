"""Carry CKKS state between the JAX package and the port, as numpy arrays.

Functions here take and return numpy arrays and plain numbers, never
objects of the JAX package, so the port still imports nothing of it.
Residues cross as uint64 (the JAX package's dtype) and live in the port
as int64.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.ckks import Ciphertext, Plaintext
from repro_torch.core.keys import EvalKey, KeyChain
from repro_torch.core.poly import PolyContext


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
