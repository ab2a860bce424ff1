"""The -devices N build over torch.distributed: the mesh and its
collectives (mesh), the streamed superkmer-routed counting (pipeline),
the sharded compaction (distcompact) and the rank launcher (launch)."""
