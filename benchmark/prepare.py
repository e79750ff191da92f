"""``run_harmony``'s steps up to the rounds, through the port's library
functions, for an embedding that is already on the device; and one job.

The set-up resolves the configuration as ``run_harmony`` does
(``preprocess.build_design``, ``resolve_config`` with the reference
package's defaults, ``config.finalize_engine_config``), builds the
ingest order (``api.ingest_perm``, ``api.apply_ingest_order``), the
M-step layout (``engine.mstep_layout``) and the hyperparameters
(``expand_hyperparams``), and puts the device embedding into the ingest
order with one gather. A job is what ``run_harmony`` does after its
ingest: ``state.init_state`` and ``driver.run`` (k-means init, then the
iterations with the early stop), ended by a synchronise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


class Prepared(NamedTuple):
    cfg: object  # the finalised HarmonyConfig
    design: object  # the DesignMatrix in ingest order
    layout: object  # the run's engine.MStepLayout
    hp: object  # the expanded hyperparameters
    Z: torch.Tensor  # (d, Np) the embedding in ingest order, engine dtype, pads zero
    device: torch.device


def settings(conf: dict) -> dict:
    """The configuration's Harmony settings over the reference defaults."""
    s = {"nclust": None, "theta": None, "sigma": 0.1, "lambda": None, "max_iter": 10,
         "early_stop": True, "dtype": "float32", "options": {}}
    s.update(conf.get("harmony", {}))
    return s


def prepare(conf: dict, traffic: dict, Z: torch.Tensor, labels: torch.Tensor, seed: int,
            fields: Optional[dict] = None) -> Prepared:
    """The configuration resolved and the embedding ``Z`` (N, d) with its
    batch ``labels`` (N,) put in ingest order, as ``run_harmony`` would
    with ``seed`` and the traffic mix's schedule; ``fields`` (tests)
    sets HarmonyConfig fields over the defaults."""
    from harmony_tpu_torch import api, engine
    from harmony_tpu_torch.config import finalize_engine_config, harmony_options
    from harmony_tpu_torch.preprocess import build_design, expand_hyperparams, resolve_config

    dev = Z.device
    s = settings(conf)
    design = build_design({"batch": labels.cpu().numpy()}, ["batch"])
    N, d = Z.shape
    options = harmony_options(**s["options"])
    cfg = resolve_config(
        n_cells=N, d=d, design=design, nclust=s["nclust"], max_iter=s["max_iter"],
        early_stop=s["early_stop"], options=options, verbose=False,
        lambda_estimation=s["lambda"] is None, dtype=s["dtype"], ridge_solver="auto",
        shuffle_mode=traffic["shuffle_mode"], matmul_precision="auto")
    cfg = finalize_engine_config(dataclasses.replace(
        cfg, estep_impl="auto", mstep_impl="auto", virtual_r=None, **(fields or {})))
    hp = expand_hyperparams(design, cfg.K, s["theta"], s["sigma"], s["lambda"], options.tau)
    perm, _ = api.ingest_perm(cfg, design, seed)
    _, design, _ = api.apply_ingest_order(design, perm)
    layout = engine.mstep_layout(cfg, design.codes, dev)
    dtype = getattr(torch, cfg.dtype)
    Ze = torch.zeros((d, cfg.Np), dtype=dtype, device=dev)
    src = Z if perm is None else Z.index_select(0, torch.as_tensor(perm, device=dev))
    Ze[:, :N] = src.t().to(dtype)
    return Prepared(cfg=cfg, design=design, layout=layout, hp=hp, Z=Ze, device=dev)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def job(p: Prepared, seed: int, timers=None):
    """One integration of the prepared embedding from the job's ``seed``;
    returns the state it leaves, its work done on the device."""
    from harmony_tpu_torch import driver
    from harmony_tpu_torch.state import init_state

    state = init_state(p.cfg, p.Z, p.design, p.hp.sigma, p.hp.theta, p.hp.lamb, seed,
                       p.device)
    state = driver.run(p.cfg, state, timers=timers, layout=p.layout)
    synchronize(p.device)
    return state


def job_seed(seed: int, j: int) -> int:
    """The seed of the window's job ``j`` (the warm-up jobs are negative):
    63 bits of a hash of (run seed, j), so every job draws anew and both
    sides of a comparison run the same sequence."""
    import hashlib

    h = hashlib.sha256(f"{int(seed)}:{int(j)}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def iterations(state) -> int:
    return int(state.n_harmony) - 1
