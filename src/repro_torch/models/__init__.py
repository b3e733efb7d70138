"""Models of the port: the dense and xLSTM decoder-only families of ``repro.models``.

Layers and the model are ``nn.Module``s whose parameter names follow the
JAX parameter tree (``convert.params_from_jax`` maps one onto the other);
the functions keep the JAX names and take the module where JAX takes the
parameter dict. ``sharding.py`` is ``repro.models.sharding``: the models make
the JAX package's ``constrain`` calls, which record layouts under a sharding
context and are the identity without one; the ops those layouts pin run per
position of the context's mesh.
"""
