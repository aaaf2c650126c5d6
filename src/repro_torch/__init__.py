"""PyTorch / CUDA port of the elastic-consistency system.

A second package beside the JAX reference (``repro``), mirroring its module
layout: ``configs``, ``core``, ``data``, ``optim``, ``models``, ``dist``,
``kernels`` and ``launch``.  It imports ``torch`` only.  Kernels are written
by hand for Hopper (``sm_90a``) and built at first use; on CPU tensors every
kernel wrapper takes its plain PyTorch version instead.
"""
