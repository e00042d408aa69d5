"""Host data pipeline: patch store, datasets, loader (counterpart of
``eld_tpu.data``)."""
