"""The port's examples, the counterparts of the root ``examples/`` scripts.

Each runs as ``python -m repro_torch.examples.<name>``, on the card unless
given ``--device cpu``: ``quickstart``, ``strassen_distributed``, ``serve``
and ``train_e2e``.
"""
