"""Per-tenant key/evk registry over ONE shared engine.

Multi-tenant serving separates two kinds of state the single-program
runtime kept fused together:

* **engine plans** (``KeyswitchEngine._plans``, one per level) contain
  NO key material — they are shared
  by every tenant, which is exactly what makes cross-tenant serving
  retrace-free: tenant B's first request reuses the plan tenant A
  traced.
* **key material** (secret key, mult/conj keys, per-step rotation evks)
  is per tenant.  The registry owns one ``KeyChain`` per tenant, seeded
  deterministically, and installs it on the shared ``CKKSContext`` for
  the duration of a ``lease`` — the engine's evk *tensor* caches are
  keyed by ``id(evk)`` so tenants never collide (ARK-style
  inter-operation key reuse happens per tenant, across that tenant's
  blocks and batches).

Eviction is bounded-LRU over tenants: creating tenant ``capacity + 1``
evicts the least-recently-used tenant that is **not in flight** (an
active lease pins its keys — evicting mid-batch would invalidate evk
tensors the running dispatch still references).  Eviction also
purges the engine's stacked/Montgomery evk tensors for the dead
tenant's keys, so registry memory is genuinely bounded.

A copy of the JAX package's ``serve/registry.py`` on the port's
engine, whose three evk caches (``_evk_full``, ``_evk_level``,
``_evk_group``) hold the only other references to a tenant's evk
tensors: purging them on eviction hands the tensors' device memory back
to the allocator.  ``hamming_weight`` (default: uniform ternary, as the
JAX package) gives every tenant a sparse secret: a server of
bootstrapping programs needs one (``core/bootstrap.py``), and so do deep
programs at N = 2^16, where the bias that rescale's floor rounding
leaves grows with the secret's weight.
"""
from __future__ import annotations

import contextlib

from repro_torch.core.ckks import CKKSContext
from repro_torch.core.keys import KeyChain
from repro_torch.errors import ConfigError, KeyUnavailableError

_EVICT_HINT = ("tenant keys were LRU-evicted; re-enroll the tenant "
               "(lease/warmup regenerates them bit-identically from its "
               "stable seed) or raise the registry capacity")


class TenantRegistry:
    """Bounded LRU of per-tenant ``KeyChain``s bound to one context."""

    def __init__(self, ctx: CKKSContext, capacity: int = 8,
                 base_seed: int = 1000, hamming_weight: int | None = None):
        if capacity <= 0:
            raise ConfigError("registry capacity must be positive",
                              hint="at least one tenant must fit",
                              capacity=capacity)
        self.ctx = ctx
        self.capacity = capacity
        self.base_seed = base_seed
        self.hamming_weight = hamming_weight
        self._chains: dict[str, KeyChain] = {}   # insertion = LRU order
        self._seeds: dict[str, int] = {}
        self._inflight: dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._chains

    def __len__(self) -> int:
        return len(self._chains)

    # ------------------------- keychains -------------------------------
    def _tenant_seed(self, tenant: str) -> int:
        """Stable per-tenant seed: the tenant's keys survive eviction +
        re-admission bit-identically (re-keygen, not re-keying)."""
        if tenant not in self._seeds:
            self._seeds[tenant] = self.base_seed + len(self._seeds)
        return self._seeds[tenant]

    def keychain(self, tenant: str, create: bool = True) -> KeyChain:
        """The tenant's keys, creating (and possibly evicting) on miss.

        ``create=False`` is the strict lookup: a request that references
        a tenant whose keys were evicted gets a typed
        :class:`KeyUnavailableError` carrying the tenant id and the
        remediation (NOT a bare ``KeyError``) — the server's retry path
        treats it as recoverable because re-keygen is deterministic.
        """
        if tenant in self._chains:
            self.hits += 1
            self._chains[tenant] = self._chains.pop(tenant)  # LRU bump
            return self._chains[tenant]
        self.misses += 1
        if not create:
            raise KeyUnavailableError(
                f"tenant '{tenant}' has no resident key material",
                hint=_EVICT_HINT, tenant=tenant,
                resident=len(self._chains), capacity=self.capacity)
        while len(self._chains) >= self.capacity:
            if not self._evict_one():
                break        # every resident tenant is in flight
        kc = KeyChain(self.ctx.params, self.ctx.pc,
                      seed=self._tenant_seed(tenant),
                      hamming_weight=self.hamming_weight)
        self._chains[tenant] = kc
        return kc

    def _evict_one(self) -> bool:
        """Drop the LRU tenant that is not in flight; purge its evk
        tensors from the engine caches.  False if none is evictable."""
        for tenant in self._chains:        # insertion order == LRU order
            if self._inflight.get(tenant, 0) == 0:
                self.evict(tenant)
                return True
        return False

    def evict(self, tenant: str, force: bool = False) -> bool:
        """Evict one tenant's keys and purge its engine evk tensors.

        ``force=True`` evicts even an in-flight tenant — that is the
        fault the injection harness uses to exercise the server's
        ``KeyUnavailableError`` recovery; normal LRU eviction never
        does this (an active lease pins the keys).
        """
        if tenant not in self._chains:
            return False
        if not force and self._inflight.get(tenant, 0) > 0:
            return False
        kc = self._chains.pop(tenant)
        self._purge_engine_caches(kc)
        self.evictions += 1
        return True

    def _purge_engine_caches(self, kc: KeyChain) -> None:
        engine = self.ctx.engine
        dead = {id(k) for k in kc._rot_keys.values()}
        for k in (kc._mult_key, kc._conj_key):
            if k is not None:
                dead.add(id(k))
        engine._evk_full = {i: v for i, v in engine._evk_full.items()
                            if i not in dead}
        engine._evk_level = {k: v for k, v in engine._evk_level.items()
                             if k[0] not in dead}
        engine._evk_group = {k: v for k, v in engine._evk_group.items()
                             if not (set(k[0]) & dead)}

    # ------------------------- leases ----------------------------------
    @contextlib.contextmanager
    def lease(self, tenant: str, create: bool = True):
        """Install the tenant's keys on the shared context and pin them
        against eviction while the lease is held (re-entrant).
        ``create=False`` raises :class:`KeyUnavailableError` instead of
        re-keygen when the tenant was evicted."""
        kc = self.keychain(tenant, create=create)
        prev = self.ctx.keys
        self.ctx.keys = kc
        self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        try:
            yield kc
        finally:
            self._inflight[tenant] -= 1
            if self._inflight[tenant] == 0:
                del self._inflight[tenant]
            self.ctx.keys = prev

    def inflight(self, tenant: str) -> bool:
        return self._inflight.get(tenant, 0) > 0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "tenants_resident": len(self._chains),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hits / total if total else 1.0,
        }
