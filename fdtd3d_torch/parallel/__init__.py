"""Domain decomposition of the PyTorch port, in one process.

Counterpart of ``fdtd3d_tpu/parallel/``: the topology authority
(``mesh.choose_topology``/``mesh.resolve_topology``), the shard layout
(``mesh.ShardMesh``: one device per shard, repeats allowed) with the
split and join of the global state and coefficient trees, and the host
gather (``distributed.gather_to_host``). Several processes meeting
through ``torch.distributed`` are ROADMAP.md item A11(b).
"""
