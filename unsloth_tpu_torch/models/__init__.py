"""Model configuration, parameter trees, checkpoint loading and the
user-facing FastLanguageModel facade."""
