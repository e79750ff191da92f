"""K4 and K5: the wrappers of the single-covariate M-step kernels.

Counterpart of ``harmony_tpu/ops/pallas_ridge.py`` (``pallas_moments``,
``pallas_correction``). The CUDA source is ``csrc/ridge.cu``.

* :func:`moments` — M[k, b, e] = sum_n R[k,n] [code(n)==b] [Z;1][e,n]:
  per-batch ridge right-hand sides with the O row at ``[..., -1]``.
* :func:`correction` — Z_corr = Z - sum_k R[k,n] W[k, code(n), :]
  (src/harmony.cpp:613-616).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (:func:`moments_twin`, :func:`correction_twin`) for CPU tensors;
anything else raises. ``launches`` counts calls into the kernel's C entry
point.
"""

from __future__ import annotations

import torch

from .. import _build

_F32 = torch.float32
_SMEM_MAX = 232_448  # bytes of shared memory a CTA may use on Hopper
_CT = 64  # cells per staged tile (kCT in ridge.cu)
_CTP = _CT + 1
_SIGNATURES = {
    "k4_moments": [_build.PTR] * 5 + [_build.I64, _build.INT, _build.INT,
                                      _build.INT, _build.INT, _build.INT,
                                      _build.I64, _build.INT, _build.PTR],
    "k5_correction": [_build.PTR] * 5 + [_build.I64] + [_build.INT] * 4
    + [_build.PTR],
}


def _check_inputs(where, tensors, codes):
    dev = codes.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{where}: {name} is on {t.device}, codes on {dev}")
        if t.dtype != _F32:
            raise TypeError(f"{where}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous")
    if codes.dtype != torch.int32 or codes.dim() != 1 or not codes.is_contiguous():
        raise TypeError(f"{where}: codes must be a contiguous (N,) int32 tensor")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{where}: unsupported device {dev}")


def moments_twin(R, Z, codes, B: int) -> torch.Tensor:
    """Plain version of K4: one masked product per batch."""
    K, N = R.shape
    Za = torch.cat([Z, Z.new_ones((1, N))], dim=0)
    M = torch.zeros((K, B, Z.shape[0] + 1), dtype=_F32, device=R.device)
    for b in range(B):
        sel = (codes == b).nonzero().squeeze(1)
        M[:, b, :] = R.index_select(1, sel) @ Za.index_select(1, sel).t()
    return M


def moments(R: torch.Tensor, Z: torch.Tensor, codes: torch.Tensor, B: int
            ) -> torch.Tensor:
    """Return M (K, B, d+1) for R (K, N), Z (d, N), codes (N,) in [0, B)."""
    _check_inputs("moments", {"R": R, "Z": Z}, codes)
    K, N = R.shape
    d = Z.shape[0]
    if Z.shape[1] != N or codes.shape[0] != N:
        raise ValueError(f"moments: shapes R {tuple(R.shape)}, Z {tuple(Z.shape)}, "
                         f"codes {tuple(codes.shape)} disagree")
    if codes.device.type == "cpu":
        return moments_twin(R, Z, codes, B)
    d1 = d + 1
    for KT in (16, 8, 4, 2, 1):
        smem = 4 * (B * KT * d1 + KT * _CTP + d1 * _CTP + _CT)
        if smem <= _SMEM_MAX:
            break
    else:
        raise ValueError(
            f"moments: B={B}, d={d} need {smem} bytes of shared memory at one "
            f"cluster row per CTA, over the {_SMEM_MAX} a CTA may use"
        )
    # about four CTAs per SM: cell-range splits times cluster tiles
    n_kt = -(-K // KT)
    n_sm = torch.cuda.get_device_properties(R.device).multi_processor_count
    NS = max(1, min(-(-N // _CT), -(-4 * n_sm // n_kt)))
    chunk = -(-(-(-N // NS)) // _CT) * _CT
    NS = -(-N // chunk)
    part = torch.empty((NS, K, B, d1), dtype=_F32, device=R.device)
    M = torch.empty((K, B, d1), dtype=_F32, device=R.device)
    lib = _build.load("ridge", _SIGNATURES)
    stream = torch.cuda.current_stream(R.device).cuda_stream
    _build.check(lib.k4_moments(
        R.data_ptr(), Z.data_ptr(), codes.data_ptr(), part.data_ptr(),
        M.data_ptr(), N, K, d, B, KT, NS, chunk, smem, stream,
    ), "k4_moments")
    moments.launches += 1
    return M


moments.launches = 0


def correction_twin(W, R, Z, codes) -> torch.Tensor:
    """Plain version of K5: one product per batch over its cells."""
    out = Z.clone()
    for b in range(W.shape[1]):
        sel = (codes == b).nonzero().squeeze(1)
        out[:, sel] = Z.index_select(1, sel) - W[:, b, :].t() @ R.index_select(1, sel)
    return out


def correction(W: torch.Tensor, R: torch.Tensor, Z: torch.Tensor,
               codes: torch.Tensor) -> torch.Tensor:
    """Return Z_corr (d, N) for W (K, B, d) batch betas, R (K, N), Z (d, N)."""
    _check_inputs("correction", {"W": W, "R": R, "Z": Z}, codes)
    K, N = R.shape
    d = Z.shape[0]
    B = W.shape[1]
    if W.shape != (K, B, d) or Z.shape[1] != N or codes.shape[0] != N:
        raise ValueError(f"correction: shapes W {tuple(W.shape)}, R {tuple(R.shape)}, "
                         f"Z {tuple(Z.shape)}, codes {tuple(codes.shape)} disagree")
    if codes.device.type == "cpu":
        return correction_twin(W, R, Z, codes)
    smem = 4 * ((K + d) * _CTP + _CT)
    if smem > _SMEM_MAX:
        raise ValueError(
            f"correction: K={K}, d={d} need {smem} bytes of shared memory; "
            f"the kernel takes K + d <= {(_SMEM_MAX // 4 - _CT) // _CTP}"
        )
    Zc = torch.empty_like(Z)
    lib = _build.load("ridge", _SIGNATURES)
    stream = torch.cuda.current_stream(R.device).cuda_stream
    _build.check(lib.k5_correction(
        W.data_ptr(), R.data_ptr(), Z.data_ptr(), codes.data_ptr(),
        Zc.data_ptr(), N, K, d, B, smem, stream,
    ), "k5_correction")
    correction.launches += 1
    return Zc


correction.launches = 0
