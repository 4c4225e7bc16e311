"""On the card: each driver at a small bf16 size through the port's CUDA
kernels, checked against the reference.  Run on a machine with a GPU:

  PYTHONPATH=src python -m pytest -q -m cuda port_bench/tests
"""
import dataclasses

import pytest

from port_bench import common
from port_bench.drivers import prefill, train

from port_bench.tests.test_port_bench_run import PREFILL, TRAIN, small


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", TRAIN + PREFILL)
def test_small_bf16_run_on_the_card_is_close_to_the_reference(workload, card):
    cell = small(workload)
    model = dict(cell.config["model"], dtype="bfloat16", ssm_head_dim=64, ssm_chunk=64)
    cell = dataclasses.replace(cell, config=dict(cell.config, model=model), device=card)
    drv = train if workload in TRAIN else prefill
    rec = drv.run(cell, 0.0)
    assert rec.window_s > 0 and rec.work > 0
    assert all(v < 0.25 for v in rec.numbers.values()), rec.numbers
