"""Cells of the benchmark cut to sizes that a CPU test run holds: the
same files and code paths, smaller grids, depths, widths and batches."""

import copy

import torch

from perfbench import harness


def design_cell(verify_steps: int = 40, regrasp: int = 20):
    cell = copy.deepcopy(harness.load_cell("dgdm-2d.design"))
    cell.config.update(grid_size=4, num_pos=1, verify_steps=verify_steps,
                       verify_regrasp=regrasp, sub_bs=2,
                       objects=cell.config["objects"][:2])
    cell.config["classifier"].update(width=32, num_trunk=2)
    cell.config["unet"].update(down_dims=[16, 32], n_groups=4)
    cell.params.update(batch=2, block=6, check_requests=1)
    return cell


def datagen_cell(steps: int = 60):
    cell = copy.deepcopy(harness.load_cell("dgdm-3d.datagen"))
    cell.config.update(grid_size=2, num_pos=1, datagen_steps=steps,
                       pairs_per_wave=2)
    cell.params.update(check_pairs=2)
    return cell


CPU = torch.device("cpu")
