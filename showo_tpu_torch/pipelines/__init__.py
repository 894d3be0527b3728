"""Inference pipelines (counterpart of ``showo_tpu.pipelines``)."""
