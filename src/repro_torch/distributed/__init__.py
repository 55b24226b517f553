"""Sharding layer of the port: the ambient mesh (``context``) and the
logical-axis rules that place parameters, caches and batches on a
``torch.distributed`` ``DeviceMesh`` (``sharding``)."""
