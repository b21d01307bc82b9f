"""The JAX package's stream-measuring tools on the card, by file name:
``stream_ladder`` (``read_kernel``, ``write_kernel``, ``copy_kernel``,
``time_chain`` and the ladder's ``main``), ``pipeline_experiment``
(``make_pipeline``) and ``grid_experiment`` (``grid_copy``), each a
factory that returns a callable on tensors over the kernels of
``ops/stream_ladder.py``."""
