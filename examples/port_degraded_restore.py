"""Fault-tolerance walkthrough on the PyTorch/CUDA port: erasure-coded
checkpoints and live state parity.

``examples/degraded_restore.py`` on ``repro_torch``:

1. save a training state into the ZapRAID checkpoint log (RAID-6 across 5
   lanes: survives any TWO lane losses);
2. crash the host; remount the log from the drives (crash consistency 3.4);
3. fail two lanes; restore WITHOUT rebuilding (degraded reads decode);
4. beyond the paper: erasure-code live optimizer shards across 4 DP ranks
   and rebuild a lost rank's shard on the device (no checkpoint read).

The state lives on ``--device`` and the codec's kernels run there: on
``cuda`` (the default) the RAID-6 encode and the two-erasure decode launch
``gf256_matmul`` and the state parity ``stripe_xor``.

Run: PYTHONPATH=src python examples/port_degraded_restore.py [--device cpu]
"""
import argparse
import hashlib

import numpy as np
import torch

from repro_torch.checkpoint.state_parity import encode_shards, reconstruct_shard
from repro_torch.checkpoint.zapraid_ckpt import CheckpointConfig, CheckpointEngine
from repro_torch.core.raid import check_device
from repro_torch.core.zns import drive_images


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = check_device(args.device)

    rng = np.random.default_rng(0)
    state = {"params": {"w": torch.from_numpy(rng.standard_normal((64, 64)))
                        .to(dev, torch.float32)},
             "step": torch.tensor(123, dtype=torch.int32, device=dev)}

    eng = CheckpointEngine(
        CheckpointConfig(n_lanes=5, scheme="raid6", group_size=8,
                         block_bytes=512, zone_cap_blocks=256, n_zones=64,
                         chunk_blocks=2, device=args.device),
        logical_blocks=1 << 13,
    )
    eng.save(123, state)
    print("checkpoint saved (RAID-6 over 5 lanes)")

    # host crash first (all lanes intact): remount from the log (crash recovery 3.4)
    eng = eng.crash_and_remount()
    recovered = 123 in eng.catalog
    print("crash + remount -> catalog recovered:", recovered)

    # now lose TWO lanes and restore without rebuilding (degraded reads decode)
    eng.fail_lane(1)
    eng.fail_lane(3)
    out = eng.restore(123, state)
    ok = torch.equal(out["params"]["w"], state["params"]["w"])
    print(f"two lanes failed -> degraded restore correct: {ok} "
          f"({eng.array.stats.degraded_reads} degraded reads)")

    # --- live optimizer-state parity across DP ranks (beyond-paper) -------
    k = 4
    shards = [{"m": torch.from_numpy(rng.standard_normal((32, 16))).to(dev, torch.float32)}
              for _ in range(k)]
    parity = encode_shards(shards, m=1)
    lost = 2
    rec = reconstruct_shard(lost, {r: shards[r] for r in range(k) if r != lost},
                            parity, k)
    rebuilt = torch.equal(rec["m"], shards[lost]["m"])
    print("lost DP rank 2's optimizer shard reconstructed on-device:", rebuilt)
    return {"catalog_recovered": recovered, "degraded_restore_correct": ok,
            "degraded_reads": eng.array.stats.degraded_reads, "rank_rebuilt": rebuilt,
            "parity": hashlib.sha256(parity[0]["m"].cpu().numpy().tobytes()).hexdigest(),
            "media": drive_images(eng.array.drives)}


if __name__ == "__main__":
    main()
