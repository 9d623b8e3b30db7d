"""The port's OCI hook chain in CUDA form: ``hook.cc``
(``elastic-gpu-hook``), ``toolkit.cc`` (``elastic-gpu-container-toolkit``),
``mount_elastic_gpu.c``, their JSON parser, :mod:`build` and
``install.sh``."""
