"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: ``run.py``
runs one cell once (see ``README.md``)."""
