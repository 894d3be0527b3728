"""Host-side data loading of the trainers (jsonl image-text datasets, the
batch loader, the multi-loader mixer)."""
