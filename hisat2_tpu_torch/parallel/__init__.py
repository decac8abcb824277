"""Several devices (the PyTorch port of hisat2_tpu/parallel): reads are
data-parallel over a torch.distributed DeviceMesh, genome shards
model-parallel along its second axis (parallel/mesh.py); several hosts
exchange novel splice sites between batch rounds (parallel/multihost.py).
One process drives one device, as torchrun starts them."""
