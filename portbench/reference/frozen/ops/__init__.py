"""Plain ops of the reference: audio transforms and attention masks."""
