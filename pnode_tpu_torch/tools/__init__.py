"""Tools of the port: ``probe_smem_limit`` (K13), the card's largest dynamic
shared memory per block and the co-resident capacities the loop kernels'
grids assume (counterpart of ``tools/probe_vmem_limit.py``)."""
