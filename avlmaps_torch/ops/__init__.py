"""Device ops: kernel wrappers with their plain versions (fused_vit,
segment_scatter, similarity, clip_resample, sinkhorn), the voxel fusion,
the bilinear resizes, the 3D heatmap, the query delivery heads, pooling
and morphology."""
