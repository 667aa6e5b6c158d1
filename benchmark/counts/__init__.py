"""The benchmark's own operation and byte counts (its yardstick): peaks of
the chip, the memory lookups B1 and B2, the int8 convolutions, the
generator's forward a window, FlowNet2-SD a frame pair and the stage-2
training step.  Nothing here reads the port."""
