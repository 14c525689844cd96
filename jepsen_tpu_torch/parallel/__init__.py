"""Sharded checking: the mesh of torch devices (`mesh`), batched
multi-history checking (`batch`), one history's sweep split over a mesh
(`op_shard`), the 2D batch x sweep mesh (`hybrid`) and the default-mesh
resolution (`slots`); SURVEY.md §2.7."""
