"""Examples of the torch port, counterparts of the JAX package's
``examples/``. Each runs as ``python -m tensorbnn_tpu_torch.examples.<name>
[--cpu] [--smoke]`` on the CUDA card (``--cpu`` runs it on the CPU) and
has a ``main(argv=None)`` that returns the statistics it prints."""
