"""The array-state scheduler's decision core (``kernels``): the port of
``ray_tpu/_private/scheduler/kernels.py``."""
