"""Protocol core: topology, packing, push-sum, sensitivity, privacy, DPPS,
partition and PartPSP (mirrors ``repro.core``)."""
