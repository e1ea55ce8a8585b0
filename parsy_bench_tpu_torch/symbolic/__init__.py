"""The port's inspector: its own copies of the JAX package's ``etree``,
``colcounts``, ``ordering``, ``supernodes`` and ``splan`` modules, and of
the multi-device tier's ``partition`` and ``dplan``."""
