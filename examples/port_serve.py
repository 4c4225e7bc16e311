"""Serving on the PyTorch/CUDA port: prefill + batched decode with KV caches.

``examples/serve.py`` on ``repro_torch``: a reduced qwen2.5-3b-family model
prefills a batch of prompts, then decodes 16 tokens greedily, through the
port's serving loop (``launch/serve.py``'s ``serve``, which grows the KV
caches by the decode budget after prefill, as the reference pads them).
The model runs on ``--device`` (``cuda`` by default, or ``cpu``), randomly
initialised from seed 0 on the CPU (the same weights on every device), or
from ``init_params``, a reference parameter
tree of numpy leaves (``models/convert.py``), which makes the generated
tokens the reference's.

Run: PYTHONPATH=src python examples/port_serve.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.raid import check_device
from repro_torch.launch.serve import serve
from repro_torch.models.config import smoke
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import build_model

B, T, NEW = 4, 24, 16


def main(argv=None, *, init_params: dict | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = check_device(args.device)
    cfg = smoke(get_config("qwen2.5-3b"))
    # drawn on the CPU from seed 0: the same weights on every device
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    if init_params is not None:
        load_jax_params(model, init_params)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (B, T))
    st = serve(model, list(prompts), batch=B, gen_len=NEW)
    gen = np.stack(st.outputs)
    print(f"prefilled {B}x{T}, decoded {NEW} tokens each:")
    print(gen)
    return {"tokens": gen.tolist()}


if __name__ == "__main__":
    main()
