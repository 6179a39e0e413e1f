"""The LM substrate: configuration, layers, attention (GQA, MLA, local
windows), the mixture of experts, the RG-LRU and xLSTM recurrences, the
transformer and its train, prefill and decode steps, for every config the
reference runs."""
