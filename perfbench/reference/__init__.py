"""The plain reference that decides ``correct``.  It imports nothing of the
port (``mysticeti_tpu_torch``) and nothing of the JAX package."""
