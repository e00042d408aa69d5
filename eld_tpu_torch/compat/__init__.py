"""Weight interchange with the JAX package (``eld_tpu``)."""
