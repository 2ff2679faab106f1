"""The inverse-rendering examples of the port (the counterparts of the
repository's ``examples/inverse_rendering.py`` and
``examples/inverse_demo.py``), each run as
``python -m tinyraytracing_tpu_torch.examples.<name>``."""
