"""Multi-rank serving: process-group bring-up, the (data, model) mesh and
the tensor-parallel plans (port of ``cogstream_tpu/parallel``)."""
