"""Model layer: MobileNetV2 backbone, multibox head, SSD, decoder."""
