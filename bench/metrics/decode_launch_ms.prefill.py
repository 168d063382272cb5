"""The median host milliseconds of the port's ``serve.decode.launch``
region in the traced stretch of the prefill-heavy serving cell, read as
``decode_launch_ms.serve`` reads it: the host issuing one decode step of
27 layers of MLA and experts."""
from harness.spec import metric_reader

read = metric_reader("decode_launch_ms.serve")
