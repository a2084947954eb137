"""The EdgeRIC RT-E2 wire schema (``edgeric.proto``, package
``edgeric_tpu``) and its generated module ``edgeric_pb2``.

The port's own copy: its serialized descriptor is byte-identical to the
JAX package's, so both register as one file in protobuf's default pool and
the two packages exchange the same bytes.  Importing it needs the
``protobuf`` package; only ``runtime.edgeric.EdgericAgent`` and
``ric.messenger.RicMessenger`` do so, inside their constructors.
"""
