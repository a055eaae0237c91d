"""Flex prefill attention: ``ops.flex_attention`` is the public op,
``flex_attention`` the K4 kernel module, ``ref`` the plain oracle.
(Unlike the JAX package, the op is not re-exported here: it would shadow
the ``flex_attention`` submodule.)"""
