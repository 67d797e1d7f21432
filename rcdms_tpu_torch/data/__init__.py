"""The story data protocol (numpy) and the story datasets."""
