from ray_tpu_torch.rllib.offline.json_io import JsonReader, JsonWriter, fill_replay, read_episodes, write_episodes

__all__ = ["JsonReader", "JsonWriter", "fill_replay", "read_episodes", "write_episodes"]
