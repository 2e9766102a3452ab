"""Out-of-core genotype operator: packed words stay in HOST memory and every
full-width pass streams SNP blocks through the device.

Why this exists (reference analog): the reference mmaps `.bed` files, so its
working set is `2np` bits of *virtual* memory and UK-Biobank-scale problems
(500k x 500k ~ 62 GB, reference docs/src/man/FAQ.md:31-33) run on any node
with enough RAM.  One device caps the resident design at its memory.  The
first-choice answer is to shard SNPs across devices (`parallel/`); this
module is the single-device fallback: `X'R` / `col_moments` stream
(block_p/4, n4) quad-word blocks
host->device, with the transfer of block i+1 issued before block i's kernel
result is consumed (JAX async dispatch overlaps them), and the k-sparse
forward products gather only their S quad rows from host memory.

Streamed passes are bound by the host link, far below the device's memory
bandwidth (not measured on a GPU yet), so use `HostStreamedGenotypes` only
when the packed matrix does not fit the device.

The solver integration is the host-stepped driver in
`models/streamed.py` (the jitted `lax.while_loop` solver cannot call
host code from inside the trace).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from . import decode
from ..genotype.snparray import (PackedGenotypes, _bytes_to_words,
                                 _repack_bed_host, _ceil_to, _LANE)


def _resident_budget() -> int:
    """Device bytes the streamed operator may pin resident (hybrid
    residency): half of what the device's allocator reports, leaving the
    rest for solver state, block double-buffers and outputs.  The CPU
    backend reports no limit (its arrays are host memory already), and
    there the operator pins nothing."""
    from ..utils.device import memory_limit_bytes
    limit = memory_limit_bytes()
    return 0 if limit is None else limit // 2


@dataclasses.dataclass
class HostStreamedGenotypes:
    """2-bit packed genotypes resident in host RAM (words layout), streamed
    through the device block-by-block.  Same statistics/layout contract as
    :class:`PackedGenotypes`; `mu`/`inv_sd` are small and live on device.

    HYBRID RESIDENCY: up to ``resident_bytes`` of the leading quad-word rows
    are pinned in device memory once at operator build; full-width passes
    then stream only the remainder.  ``resident_bytes=None`` pins half the
    device's memory (see :func:`_resident_budget`); 0 streams everything."""

    words_np: np.ndarray          # (ceil(p/4), n4) int32 quad words, host
    mu: jnp.ndarray               # (p,) device
    inv_sd: jnp.ndarray           # (p,) device
    n: int
    p: int
    has_missing: bool
    block_bytes: int = 1 << 30    # ~1 GiB of packed words per streamed block
    resident_bytes: int | None = None

    @property
    def n_pad(self) -> int:
        return 4 * self.words_np.shape[1]

    @property
    def block_p(self) -> int:
        """SNPs per streamed block (multiple of 4: whole quad-word rows)."""
        n4 = self.words_np.shape[1]
        return 4 * max(1, int(self.block_bytes) // (n4 * 4))

    def __repr__(self):
        return (f"HostStreamedGenotypes(n={self.n}, p={self.p}, "
                f"words={self.words_np.shape} int32 HOST, "
                f"block_p={self.block_p}, has_missing={self.has_missing})")

    @classmethod
    def from_snparray(cls, geno: PackedGenotypes, block_bytes: int = 1 << 30,
                      resident_bytes: int | None = None,
                      ) -> "HostStreamedGenotypes":
        """Demote a device-resident PackedGenotypes to host storage (tests /
        problems that grew past device memory)."""
        return cls(words_np=np.asarray(geno.words), mu=geno.mu,
                   inv_sd=geno.inv_sd, n=geno.n, p=geno.p,
                   has_missing=geno.has_missing, block_bytes=block_bytes,
                   resident_bytes=resident_bytes)

    @classmethod
    def from_plink(cls, prefix: str, dtype=jnp.float32,
                   block_bytes: int = 1 << 30,
                   resident_bytes: int | None = None,
                   ) -> "HostStreamedGenotypes":
        """Read `prefix.bed` (+ .bim for p, .fam for n) straight into host
        words — the packed matrix never touches the device whole."""
        from ..genotype.plink import _bed_payload
        bed, n, p = _bed_payload(prefix)
        packed, mu, inv_sd, has_missing, maf_, n_mis = _repack_bed_host(
            bed, n, p)
        np_dtype = np.dtype(dtype)
        return cls(words_np=_bytes_to_words(packed),
                   mu=jnp.asarray(mu.astype(np_dtype)),
                   inv_sd=jnp.asarray(inv_sd.astype(np_dtype)),
                   n=n, p=p, has_missing=has_missing,
                   block_bytes=block_bytes, resident_bytes=resident_bytes)


class StreamedPackedOp:
    """Operator with the PackedOp contract over host-resident words.

    NOT a pytree: its methods execute host-side (block loop + device_put)
    and must be called eagerly — the host-stepped solver driver
    (models/streamed.py) does exactly that."""

    def __init__(self, geno: HostStreamedGenotypes):
        self.geno = geno
        budget = (geno.resident_bytes if geno.resident_bytes is not None
                  else _resident_budget())
        p4, n4 = geno.words_np.shape
        res_q = max(0, min(p4, int(budget) // (n4 * 4)))
        self.p_res = min(4 * res_q, geno.p)   # SNPs resident on device
        self._res_op = None
        if res_q > 0:
            from .linalg import PackedOp
            blk = PackedGenotypes(
                words=jax.device_put(geno.words_np[:res_q]),
                mu=geno.mu[:self.p_res], inv_sd=geno.inv_sd[:self.p_res],
                n=geno.n, p=self.p_res, has_missing=geno.has_missing,
                maf_=None, n_missing=None)
            self._res_op = PackedOp(blk)

    n = property(lambda self: self.geno.n)
    p = property(lambda self: self.geno.p)
    n_pad = property(lambda self: self.geno.n_pad)
    dtype = property(lambda self: self.geno.mu.dtype)

    # ---------------------------------------------------------------- blocks
    def _block_op(self, lo: int, hi: int) -> "object":
        """Device-resident PackedOp over SNP rows [lo, hi): one streamed block.
        `lo` is always a multiple of 4 (block_p is), so the block starts on
        a quad-word row boundary."""
        from .linalg import PackedOp
        g = self.geno
        blk = PackedGenotypes(
            words=jax.device_put(np.ascontiguousarray(
                g.words_np[lo // 4:-(-hi // 4)])),
            mu=g.mu[lo:hi], inv_sd=g.inv_sd[lo:hi],
            n=g.n, p=hi - lo, has_missing=g.has_missing,
            maf_=None, n_missing=None)
        return PackedOp(blk)

    def _blocks(self):
        """Streamed SNP ranges: everything past the resident prefix."""
        bp = self.geno.block_p
        return [(lo, min(lo + bp, self.p))
                for lo in range(self.p_res, self.p, bp)]

    @staticmethod
    def _drain(x):
        """Force block i-1's kernel (and hence its input transfer) to finish
        before queueing block i+1: bounds the in-flight host block copies to
        ~2 regardless of link speed.  Without this, a slow host->device link
        lets the async queue accumulate every block copy of the pass — a
        20.5 GB matrix OOM-killed the host at 130 GB RSS."""
        jax.block_until_ready(x)

    def xtr(self, R: jnp.ndarray) -> jnp.ndarray:
        """Standardized X'R: resident prefix on-device + one streamed pass
        over the remaining host words.

        The device_put of block i+1 is issued right after block i's kernel
        is dispatched (both async), so transfer and compute overlap; block
        i-1 is drained before queueing further (bounded memory)."""
        outs = [] if self._res_op is None else [self._res_op.xtr(R)]
        blocks = self._blocks()
        if blocks:
            nxt = self._block_op(*blocks[0])
            for b in range(len(blocks)):
                op_b = nxt
                if b + 1 < len(blocks):
                    nxt = self._block_op(*blocks[b + 1])  # async H2D next
                outs.append(op_b.xtr(R))                  # (B, pb)
                if b >= 1:
                    self._drain(outs[-2])
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)

    def col_moments(self, W: jnp.ndarray, WY: jnp.ndarray):
        outs = ([] if self._res_op is None
                else [self._res_op.col_moments(W, WY)])
        blocks = self._blocks()
        if blocks:
            nxt = self._block_op(*blocks[0])
            for b in range(len(blocks)):
                op_b = nxt
                if b + 1 < len(blocks):
                    nxt = self._block_op(*blocks[b + 1])
                outs.append(op_b.col_moments(W, WY))
                if b >= 1:
                    self._drain(outs[-2])
        Sx = jnp.concatenate([o[0] for o in outs], axis=1)
        Sxx = jnp.concatenate([o[1] for o in outs], axis=1)
        Sxy = jnp.concatenate([o[2] for o in outs], axis=1)
        return Sx, Sxx, Sxy

    # ------------------------------------------------------- sparse products
    def _rows_bytes(self, idx: jnp.ndarray) -> jnp.ndarray:
        """Gather S SNP rows from HOST quad words -> (B, S, n4) u8 on device
        (quad row gather + per-row byte select, like decode.take_rows_bytes)."""
        g = self.geno
        idx_np = np.asarray(idx)
        flat = idx_np.reshape(-1)
        rows = g.words_np[flat // 4]                       # host fancy-index
        rows_d = jax.device_put(rows)                      # (B*S, n4) i32
        sh = jnp.asarray((flat % 4) * 8, jnp.int32)[:, None]
        by = ((rows_d >> sh) & 0xFF).astype(jnp.uint8)
        B, S = idx_np.shape
        return by.reshape(B, S, g.words_np.shape[1])

    def forward_sel(self, idx: jnp.ndarray, coef: jnp.ndarray,
                    valid: jnp.ndarray) -> jnp.ndarray:
        g = self.geno
        coef_s = coef * g.inv_sd[idx] * valid
        rows = self._rows_bytes(idx)
        raw = decode.sparse_forward_rows(rows, idx, coef_s, g.mu,
                                         want_missing=g.has_missing)
        const = jnp.sum(coef_s * g.mu[idx], axis=1)
        return raw - const[:, None]

    def forward_sel_multi(self, idx: jnp.ndarray, coef: jnp.ndarray,
                          valid: jnp.ndarray) -> jnp.ndarray:
        g = self.geno
        coef_s = coef * (g.inv_sd[idx] * valid)[:, None, :]
        rows = self._rows_bytes(idx)
        raw = decode.sparse_forward_rows_multi(rows, idx, coef_s, g.mu,
                                               want_missing=g.has_missing)
        const = jnp.sum(coef_s * g.mu[idx][:, None, :], axis=2)
        return raw - const[:, :, None]

    def gather_cols(self, idx: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
        g = self.geno
        rows = self._rows_bytes(idx)
        val, miss = decode.gather_decode_rows(rows, self.dtype,
                                              want_missing=g.has_missing)
        mu = g.mu[idx][:, :, None]
        inv = g.inv_sd[idx][:, :, None]
        if g.has_missing:
            val = val + mu * miss
        out = (val - mu) * inv
        return out * valid[:, :, None]
