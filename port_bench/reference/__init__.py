"""The plain reference of the benchmark: Tacotron 2 (forward or
location-sensitive attention), WaveRNN, HiFi-GAN and Griffin-Lim
inference in plain PyTorch, and the G2P that turns the benchmark's text
into phoneme ids.  It imports nothing of the system under test."""
