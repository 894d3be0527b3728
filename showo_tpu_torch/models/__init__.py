"""Phi-1.5 / Show-o / MAGVIT-v2 modules (counterpart of
``showo_tpu.models``)."""
