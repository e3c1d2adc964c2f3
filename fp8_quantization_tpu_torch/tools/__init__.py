"""Stand-alone tools of the port: the dress rehearsal of the real-data PTQ
path and the W4A8 MobileNetV2 QAT demo."""
