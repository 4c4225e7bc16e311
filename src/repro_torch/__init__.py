"""ZapRAID's datapath and Mamba-2 serving in PyTorch, on hand-written CUDA.

The counterpart of the JAX package ``repro``, module for module: ``core``
holds the ZNS drive model, segments, L2P, the RAID codec, the array and crash
recovery, and ``core.handlers`` the timed request pipeline; ``sim`` holds
the discrete-event engine, the ZN540 device model, workloads, fault injection
and the latency recorder; ``obs`` and ``cache`` the tracing/metrics/SLO and
cache tiers the pipeline attaches; ``kernels`` holds the CUDA XOR, GF(256)
and SSD-scan kernels with their plain torch versions; ``integrity`` holds the
per-block CRC32C;
``models``, ``configs`` and ``launch`` hold the model families, the
architecture registry and the serving and training drivers; ``data``,
``optim``, ``train`` and ``distributed.compression`` the data pipeline,
AdamW, the step functions and gradient compression.  Entry points run on
``cuda`` unless the caller asks for ``cpu``.
"""
