"""K1: the wrapper of the E-step round kernel.

Counterpart of ``harmony_tpu/ops/pallas_estep.py``
(``pallas_block_update_round``), a drop-in for
:func:`harmony_tpu_torch.ops.estep.block_update_round`, which is its plain
version. The CUDA source is ``csrc/estep_round.cu``.

For CUDA tensors the round is a host loop over the blocks: one commit
launch removes block 0's old contribution, then each block gets an assign
launch over its cells and a commit launch that folds the block's partials
into E/O (in a fixed order) and removes the next block's old contribution.
The gather into block order and the scatter back stay PyTorch indexing, as
they are ``jnp`` gathers outside the kernel in JAX; so do the old-block
statistics (``pallas_estep.py:177-182``). Blocks are contiguous ranges of
the permuted cells, so no pad slots exist. For CPU tensors the wrapper
runs the plain version; anything else raises. ``launches`` counts calls
into the kernel's C entry points (2 * n_blocks + 1 a round).
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import HarmonyConfig
from .assign import block_bounds
from .estep import RoundResult, block_update_round as block_update_round_twin

_F32 = torch.float32
_SMEM_MAX = 232_448  # bytes of shared memory a CTA may use on Hopper
_WARPS = 8  # kWarps in estep_round.cu
_SIGNATURES = {
    "k1_assign": [_build.PTR] * 7 + [_build.I64, _build.I64] + [_build.INT] * 7
    + [_build.PTR],
    "k1_commit": [_build.PTR, _build.INT] + [_build.PTR] * 8
    + [_build.INT] * 4 + [_build.PTR],
}


def assign_smem_bytes(K: int, d: int, B: int, ncov: int, T: int) -> int:
    """Shared memory of one assign CTA over T cells (layout in the .cu)."""
    floats = K * d + d * T + K * (T + 1) + 2 * K * B + K + 2 * _WARPS
    return 4 * (floats + ncov * T)


def cell_tile(K: int, d: int, B: int, ncov: int) -> int:
    """Cells per assign CTA: 64, or 32 where 64 does not fit."""
    for T in (64, 32):
        if assign_smem_bytes(K, d, B, ncov, T) <= _SMEM_MAX:
            return T
    raise ValueError(
        f"E-step kernel: K={K}, d={d}, B={B}, {ncov} covariate(s) need "
        f"{assign_smem_bytes(K, d, B, ncov, 32)} bytes of shared memory at 32 "
        f"cells a CTA, over the {_SMEM_MAX} a CTA may use"
    )


def block_update_round(
    cfg: HarmonyConfig,
    Z: torch.Tensor,  # (d, N)
    Y: torch.Tensor,  # (d, K)
    R: torch.Tensor,  # (K, N)
    E: torch.Tensor,  # (K, B)
    O: torch.Tensor,  # (K, B)
    codes: torch.Tensor,  # (ncov, N) int32
    Pr_b: torch.Tensor,  # (B,)
    sigma: torch.Tensor,  # (K,)
    theta: torch.Tensor,  # (B,)
    perm: torch.Tensor,  # (N,)
) -> RoundResult:
    """One update_R round; the kernel on CUDA, the plain version on CPU."""
    dev = Z.device
    floats = {"Z": Z, "Y": Y, "R": R, "E": E, "O": O, "Pr_b": Pr_b,
              "sigma": sigma, "theta": theta}
    for name, t in {**floats, "codes": codes}.items():
        if t.device != dev:
            raise ValueError(f"block_update_round: {name} is on {t.device}, Z on {dev}")
    if dev.type == "cpu":
        return block_update_round_twin(cfg, Z, Y, R, E, O, codes, Pr_b, sigma,
                                       theta, perm)
    if dev.type != "cuda":
        raise ValueError(f"block_update_round: unsupported device {dev}")
    for name, t in floats.items():
        if t.dtype != _F32:
            raise TypeError(f"block_update_round: {name} must be float32, got {t.dtype}")
    K, N = R.shape
    d, B, ncov = Z.shape[0], cfg.B, cfg.n_covariates
    if (Z.shape != (d, N) or Y.shape != (d, K) or E.shape != (K, B)
            or O.shape != (K, B) or codes.shape != (ncov, N)
            or perm.shape != (N,)):
        raise ValueError("block_update_round: argument shapes disagree with the config")
    T = cell_tile(K, d, B, ncov)
    smem = assign_smem_bytes(K, d, B, ncov, T)

    perm = perm.to(device=dev, dtype=torch.int64)
    off = torch.as_tensor(cfg.covariate_offsets, dtype=torch.int32, device=dev)
    Z_lay = Z.index_select(1, perm)  # (d, N) in block order
    g_lay = (codes.index_select(1, perm) + off[:, None]).contiguous()
    oh = torch.zeros((N, B), dtype=_F32, device=dev)
    for c in range(ncov):
        oh += torch.nn.functional.one_hot(g_lay[c].long(), B).to(_F32)
    R_old = R.index_select(1, perm)
    bounds = block_bounds(cfg)
    rsum_old = torch.stack([R_old[:, s:s + n].sum(dim=1) for s, n in bounds])
    O_old = torch.stack([R_old[:, s:s + n] @ oh[s:s + n] for s, n in bounds])
    del R_old, oh

    Yt = Y.t().contiguous()
    E_w, O_w = E.contiguous().clone(), O.contiguous().clone()
    Pr_c, sig_c, th_c = Pr_b.contiguous(), sigma.contiguous(), theta.contiguous()
    pen = torch.empty((K, B), dtype=_F32, device=dev)
    acc = torch.zeros(2, dtype=_F32, device=dev)
    R_lay = torch.empty((K, N), dtype=_F32, device=dev)
    P = K + K * B + 2
    part = torch.empty((-(-cfg.max_block_size // T), P), dtype=_F32, device=dev)
    lib = _build.load("estep_round", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def commit(ncta: int, add: int, rm: int) -> None:
        _build.check(lib.k1_commit(
            part.data_ptr(), ncta, E_w.data_ptr(), O_w.data_ptr(),
            rsum_old.data_ptr(), O_old.data_ptr(), Pr_c.data_ptr(),
            th_c.data_ptr(), pen.data_ptr(), acc.data_ptr(), K, B, add, rm,
            stream,
        ), "k1_commit")
        block_update_round.launches += 1

    commit(0, 0, 0)
    nb = len(bounds)
    for i, (start, size) in enumerate(bounds):
        if size:  # a tiny block_size can leave blocks empty; a 0-CTA launch is refused
            _build.check(lib.k1_assign(
                Yt.data_ptr(), Z_lay.data_ptr(), g_lay.data_ptr(), pen.data_ptr(),
                sig_c.data_ptr(), R_lay.data_ptr(), part.data_ptr(), N, start,
                size, K, d, B, ncov, T, smem, stream,
            ), "k1_assign")
            block_update_round.launches += 1
        commit(-(-size // T), 1, i + 1 if i + 1 < nb else -1)

    R_out = torch.empty_like(R)
    R_out.index_copy_(1, perm, R_lay)
    return RoundResult(R=R_out, E=E_w, O=O_w, kmeans_error=acc[0], entropy=acc[1])


block_update_round.launches = 0
