"""Multi-device training: in one process, the row-shard mesh (``mesh``),
the data-parallel (``data_parallel``) and feature-parallel
(``feature_parallel``) learners and the mesh preflight (``fence``); across
processes, the ``torch.distributed`` bootstrap (``mesh.init_distributed``),
the grid's row blocks, merged-sketch bins and the cross-rank transport
(``multihost``), the distributed mapper exchange (``dist_data``), the
consistency fence (``fence``) and the ledger of collectives
(``collectivewatch``)."""
