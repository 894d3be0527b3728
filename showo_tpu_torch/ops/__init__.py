"""Masks, kernel metadata and attention kernels (counterpart of
``showo_tpu.ops``)."""
