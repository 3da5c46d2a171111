"""Sharded training: the specs and placements of a train state over a
``("data", "model")`` mesh (:mod:`.sharding`), elastic re-meshing
(:mod:`.elastic`) and the int8-compressed gradient reduce
(:mod:`.compression`)."""
