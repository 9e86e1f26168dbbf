"""The plain reference: straightforward PyTorch of the configurations'
published equations, which imports nothing of the program. Frozen here,
so that no later change to the program moves it."""
