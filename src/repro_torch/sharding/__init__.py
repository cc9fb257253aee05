"""Sharding: the reference's rules on DTensor (:mod:`.rules`) and the
kernels' call sites under a mesh (:mod:`.local`)."""
