"""One module per family of models: how a job of that family runs, where
the output check records it, and the laws its draws are held to."""
