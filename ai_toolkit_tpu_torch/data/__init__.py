"""Host-side data pipeline of the flux LoRA job: folder dataset, buckets, captions, loader, caches."""
