"""The port's inspector: its own copies of the JAX package's ``etree``,
``colcounts``, ``ordering``, ``supernodes`` and ``splan`` modules."""
