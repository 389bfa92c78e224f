"""f-BRS click-to-mask (DeepLabV3+ ResNet-50-v1s or HRNet+OCR)."""
