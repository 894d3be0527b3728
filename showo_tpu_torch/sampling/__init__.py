"""MaskGIT sampling and mask schedules (counterpart of
``showo_tpu.sampling``)."""
