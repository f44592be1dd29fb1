"""Training datasets (numpy and PIL), batched by torch's DataLoader."""
