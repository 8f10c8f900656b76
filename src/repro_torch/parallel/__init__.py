"""Multi-rank serving: the tensor-parallel plan, the sharding context and
the rules that cut a rank's shards (port of ``repro.parallel``)."""
