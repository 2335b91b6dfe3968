"""Checkpoint publishing (``publish.save_pretrained``), the OpenAI-protocol
client (``infer_api.OpenAIInference``), the dataset browser (``data_tool``)
and HF -> MDS conversion (``mds_tool``)."""
