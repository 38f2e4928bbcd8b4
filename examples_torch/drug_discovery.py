"""UC1 (paper §4): computer-accelerated drug discovery, on PyTorch.

A MeasureOverlap-style docking kernel is split over pocket chunks, explored
with LAT across its parallelism, and the resulting knowledge base drives
mARGOt at runtime as ligand batches stream through.  The overlap is plain
PyTorch on the device (the JAX package computes it with jitted `jnp` code,
outside any Pallas kernel).

    python examples_torch/drug_discovery.py                 # on the card
    python examples_torch/drug_discovery.py --device cpu    # on the host
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import time

import numpy as np
import torch

from repro_torch.autotune.dse import Lat
from repro_torch.autotune.margot import LE, Goal, KnowledgeBase, Margot, State
from repro_torch.nn.module import resolve_device

CHUNKS = [1, 2, 4, 8, 16]


def measure_overlap(ligand, pocket, chunks: int):
    pc = pocket.reshape(chunks, -1, 3)
    d = torch.amin(torch.sum((ligand[None, :, None] - pc[:, None]) ** 2, -1), 2)
    return torch.sum(torch.sqrt(torch.amin(d, 0)))


def make_inputs(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(0)
    ligands = torch.tensor(rng.normal(0, 1, (64, 96, 3)), dtype=torch.float32, device=device)
    pocket = torch.tensor(rng.normal(0, 4, (8192, 3)), dtype=torch.float32, device=device)
    return ligands, pocket


def ready(x: torch.Tensor) -> torch.Tensor:
    """`x` once the device has computed it (the host clock reads after)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


def time_for(ligand, pocket, chunks: int) -> float:
    ready(measure_overlap(ligand, pocket, chunks))  # warm up
    t0 = time.perf_counter()
    ready(measure_overlap(ligand, pocket, chunks))
    return (time.perf_counter() - t0) / chunks  # ideal-parallel model


def explore(time_of) -> Lat:
    """Design-time DSE (paper Fig. 13): `time_of(chunks)` -> seconds."""
    lat = Lat("uc1").add_var("chunks", CHUNKS)
    lat.add_metric("time", time_of)
    lat.set_num_tests(3)
    lat.tune()
    return lat


def plan(lat: Lat) -> tuple[Margot, float]:
    """Runtime autotuning: keep per-ligand latency under budget, minimize
    resources (chunks = nodes occupied)."""
    kb = KnowledgeBase.from_dse(lat.results, ["chunks"], ["time"])
    budget_s = 2 * min(r["metrics"]["time"][0] for r in lat.results)
    margot = Margot(kb, [State("sla", "time", maximize=False,
                               constraints=[Goal("lat", "time", LE, budget_s)])])
    return margot, budget_s


def dock(ligands, pocket, margot: Margot) -> list[tuple[int, torch.Tensor]]:
    """Each ligand scored at the chunks mARGOt picks, observing the mean
    latency per ligand so far; returns (chunks, score) per ligand."""
    out = []
    t0 = time.perf_counter()
    for done, ligand in enumerate(ligands):
        chunks = margot.update().knobs["chunks"]
        score = ready(measure_overlap(ligand, pocket, chunks))
        margot.observe("time", (time.perf_counter() - t0) / (done + 1))
        out.append((chunks, score))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    ligands, pocket = make_inputs(resolve_device(args.device))
    lat = explore(lambda chunks: time_for(ligands[0], pocket, chunks))
    margot, budget_s = plan(lat)
    done = len(dock(ligands, pocket, margot))
    print(f"docked {done} ligands with chunks={margot.current.knobs['chunks']} "
          f"(latency budget {budget_s*1e3:.2f} ms/ligand)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
