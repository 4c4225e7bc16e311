"""End-to-end training on the PyTorch/CUDA port.

``examples/train_e2e.py`` on ``repro_torch``: by default a fast
demonstration (reduced smollm config, 20 steps) with ZapRAID checkpointing,
a storage-lane failure at step 8, and a simulated preemption + restore at
step 14, through the port's ``launch/train.py``; ``--full`` trains the real
smollm-135m for 200 steps.  Any other flag goes on to ``launch/train.py``
after the example's own (``--steps 9`` shortens the run).  The model trains
on ``--device`` (``cuda`` by default, or ``cpu``) from the port's seed-0
init drawn on the CPU (the same weights on every device), or from
``init_params``, a reference parameter tree of numpy leaves
(``models/convert.py``), which makes the losses the reference's.

Run: PYTHONPATH=src python examples/port_train_e2e.py [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.raid import check_device
from repro_torch.launch import train
from repro_torch.models.config import smoke
from repro_torch.models.model import build_model
from repro_torch.distributed.sharding import tree_map
from repro_torch.train import steps

DEMO = ["--arch", "smollm-135m", "--steps", "20", "--ckpt-every", "5",
        "--fail-lane", "2", "--fail-at", "8", "--restart-at", "14",
        "--global-batch", "8", "--seq-len", "64"]
FULL = ["--arch", "smollm-135m", "--steps", "200", "--ckpt-every", "25",
        "--global-batch", "32", "--seq-len", "2048"]


def main(argv=None, *, init_params: dict | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full", action="store_true")
    args, rest = ap.parse_known_args(argv)
    argv = (FULL if args.full else DEMO) + rest + ["--device", args.device]
    check_device(args.device)
    rep = {}
    losses = train.run(argv, init_params=init_params or cpu_init(argv), report=rep)
    return {"losses": losses, "engine": rep["engine"]}


def cpu_init(argv) -> dict:
    """The port's seed-0 init of the run's model, drawn on the CPU (the same
    weights on every device), as the tree of numpy leaves ``train.run``
    takes for ``init_params``."""
    args = train.parse_args(argv)
    cfg = smoke(get_config(args.arch)) if args.smoke else get_config(args.arch)
    return tree_map(lambda t: t.detach().float().numpy(),
                    steps.params_of(build_model(cfg, device="cpu")))


if __name__ == "__main__":
    main()
