"""Runnable examples of the port (the reference's ``examples/``), on the
card unless ``--device cpu``: ``quickstart`` and ``train_hermes_cluster``
(Level A), ``multi_pod_hermes`` (Level B: the single trainer, then Hermes
at lmtiny)."""
