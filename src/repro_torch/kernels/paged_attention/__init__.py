"""Paged decode attention: ``ops.paged_attention`` is the public op,
``paged_attention`` the K1/K2 kernel module, ``ref`` the plain oracle.
(Unlike the JAX package, the op is not re-exported here: it would shadow
the ``paged_attention`` submodule.)"""
