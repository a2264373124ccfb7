"""Device-mesh sharding: closed-GOP lanes and slice bands over devices."""
