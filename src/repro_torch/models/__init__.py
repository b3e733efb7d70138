"""Models of the port: the dense and xLSTM decoder-only families of ``repro.models``.

Layers and the model are ``nn.Module``s whose parameter names follow the
JAX parameter tree (``convert.params_from_jax`` maps one onto the other);
the functions keep the JAX names and take the module where JAX takes the
parameter dict. ``repro.models.sharding`` has no counterpart: on one card
every ``constrain`` call is the identity, so the port leaves them out.
"""
