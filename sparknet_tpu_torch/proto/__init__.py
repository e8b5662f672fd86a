from sparknet_tpu_torch.proto.text_format import Message, parse, parse_file, serialize  # noqa: F401
