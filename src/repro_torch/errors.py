"""Typed errors the port raises, mirroring the JAX package's taxonomy.

The ciphertext-data branch serves the CKKS scheme, the keyswitch engine
and the compiled runtime's ``validate=`` checks; the serving branch,
``ConfigError`` and the retry policy serve ``repro_torch.serve``.  Every
error carries a keyword ``context`` dict and an optional ``hint``, both
rendered into ``str(err)``.
"""
from __future__ import annotations


class ReproError(Exception):
    """Root of the typed error taxonomy; carries context + a hint."""

    def __init__(self, message: str, *, hint: str | None = None,
                 **context):
        self.message = message
        self.hint = hint
        self.context = context
        super().__init__(self._render())

    def _render(self) -> str:
        parts = [self.message]
        if self.context:
            kv = ", ".join(f"{k}={v!r}" for k, v in
                           sorted(self.context.items()))
            parts.append(f"[{kv}]")
        if self.hint:
            parts.append(f"(hint: {self.hint})")
        return " ".join(parts)


class CiphertextError(ReproError):
    """The ciphertext itself is unusable — retrying cannot help."""


class LevelExhaustedError(CiphertextError):
    """No modulus level left for the requested op (rescale at level 0)."""


class ScaleDriftError(CiphertextError):
    """Ciphertext scale is NaN/non-positive or drifted off the trace."""


class ModulusChainMismatchError(CiphertextError):
    """Operands/keys disagree about the active modulus chain."""


class CorruptCiphertextError(CiphertextError):
    """Limb residues out of [0, q) (or NaN) — data corruption."""


class ServingError(ReproError):
    """The serving environment failed; the request data may be fine."""


class KeyUnavailableError(ServingError):
    """Tenant key material is not resident (evicted mid-flight)."""


class PlanCacheMissError(ServingError):
    """Strict admission refused a cold (signature, width) dispatch."""


class TransientEngineError(ServingError):
    """Transient engine fault — retry with backoff is expected to work."""


class RequestTimeout(ServingError):
    """The request's virtual-clock deadline expired before completion."""


class CircuitOpenError(ServingError):
    """Per-tenant circuit breaker is open; request shed without work."""


class InvalidRequestError(ServingError):
    """Malformed request: unknown program id, missing input tags, ..."""


class ConfigError(ReproError):
    """Invalid operator-supplied configuration value."""


# The single policy point for the server's retry loop: key eviction is
# recoverable because per-tenant seeds are stable (a re-lease regenerates
# the keys bit-identically); transient engine faults recover by design.
RETRYABLE_ERRORS = (TransientEngineError, KeyUnavailableError)


def is_retryable(err: BaseException) -> bool:
    """Should the server retry the dispatch that raised ``err``?"""
    return isinstance(err, RETRYABLE_ERRORS)
