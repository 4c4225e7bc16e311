"""ZapRAID's datapath and Mamba-2 serving in PyTorch, on hand-written CUDA.

The counterpart of the JAX package ``repro``, module for module: ``core``
holds the ZNS drive model, segments, L2P, the RAID codec, the array and crash
recovery; ``kernels`` holds the CUDA XOR, GF(256) and SSD-scan kernels with
their plain torch versions; ``integrity`` holds the per-block CRC32C;
``models``, ``configs`` and ``launch`` hold the Mamba-2 model, the
architecture registry and the serving driver.  Entry points run on ``cuda``
unless the caller asks for ``cpu``.
"""
