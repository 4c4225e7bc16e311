"""ZapRAID's datapath in PyTorch, with its stripe codec on hand-written CUDA.

The counterpart of the JAX package ``repro``, module for module: ``core``
holds the ZNS drive model, segments, L2P, the RAID codec, the array and crash
recovery; ``kernels`` holds the CUDA XOR and GF(256) kernels with their plain
torch versions; ``integrity`` holds the per-block CRC32C.  Entry points run
on ``cuda`` unless the caller asks for ``cpu``.
"""
