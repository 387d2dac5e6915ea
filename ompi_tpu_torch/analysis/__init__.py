"""Analysis: the DEVICE_RULES grammar (``rules``), shared by coll/nccl's
dispatch-time loader and CI.

The port's copy of ``ompi_tpu/analysis/__init__.py``'s ``rules`` module;
the static verifier (``commgraph``) and the comm-lint (``lint``) wait for
the tools slice (ROADMAP P18).
"""
