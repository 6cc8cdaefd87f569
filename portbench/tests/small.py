"""Cells of the benchmark cut to a size a CPU test run holds."""

import copy
import time

import torch

from portbench import harness, spec

SEED = 2**31 + 17


def small_cell(name: str, height: int = 64, width: int = 128, frames: int = 12) -> spec.Cell:
    cell = spec.cell(name, spec.load_benchmark())
    cell.config = copy.deepcopy(cell.config)
    cell.config["detector"].update(height=height, width=width)
    cell.config["frames_per_acquisition"] = frames
    return cell


def run_small(name: str, seconds: float = 0.3, seed: int = SEED, **size) -> dict:
    """One untraced run of a cut cell on the CPU (the program's plain twins)."""
    return harness.execute(small_cell(name, **size), seed, seconds, False, torch.device("cpu"),
                           time.perf_counter())
