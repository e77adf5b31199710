"""Multi-device fits: the localization cloud sharded over the ranks of
a ``torch.distributed`` process group (``sharding``)."""
