"""Multi-rank execution on torch.distributed: the port of the JAX
package's parallel/ (mesh, multihost, the coefficient-sharded four-step
NTT, the dp x tp sharded roundtrip) and of the W-sharded key switch and
gl2 GEMM.

JAX runs one program over a Mesh and lets GSPMD place the collectives
(shard_map, NamedSharding); here each rank is a process holding its local
block, the mesh is a torch DeviceMesh used for its sub-groups, and the
shard-local programs are plain functions on local tensors with the
collectives written out where GSPMD would put them.  launch.run_world
starts a world of ranks on one machine (the virtual-device mesh's
counterpart).
"""
