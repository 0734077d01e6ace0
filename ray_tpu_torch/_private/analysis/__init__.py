"""Runtime checks the runtime calls (counterparts of
``ray_tpu/_private/analysis/runtime_sanitizer.py`` and
``runtime_checks.py``). The reference's static passes (raylint) are not
ported yet."""
