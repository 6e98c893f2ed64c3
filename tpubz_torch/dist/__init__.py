"""The multi-process path: block-data-parallel compression and decoding over
the ranks of a ``torch.distributed`` process group (gloo), each rank driving
one card.

The counterpart of ``tpubz/dist``: ``sharded.make_sharded_transform`` is the
per-card batched transform (BWT, MTF, RLE2 and the compact transfer form),
``multihost.compress_multihost`` / ``decompress_multihost`` the SPMD entry
points and ``multihost.initialize`` the process group's bring-up.
"""
