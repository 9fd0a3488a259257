"""Multi-device training in one process: the row-shard mesh (``mesh``), the
data-parallel (``data_parallel``) and feature-parallel
(``feature_parallel``) learners and the mesh preflight (``fence``)."""
