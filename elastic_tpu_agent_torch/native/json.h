// Minimal JSON parser for the port's native host helpers (the agent's
// native/json.h, in its own namespace).
//
// The OCI hook chain parses the hook state (stdin), the container's OCI
// config.json and the agent's allocation specs with no dependency beyond
// the C++ standard library. It takes the full JSON grammar except \u
// escapes, each of which becomes '?': no input of the chain carries one.
#ifndef ELASTIC_GPU_JSON_H_
#define ELASTIC_GPU_JSON_H_

#include <map>
#include <memory>
#include <string>
#include <vector>

namespace egpu {

class Json;
using JsonPtr = std::shared_ptr<Json>;

class Json {
 public:
  enum Type { kNull, kBool, kNumber, kString, kArray, kObject };

  Type type = kNull;
  bool bool_value = false;
  double num_value = 0;
  std::string str_value;
  std::vector<JsonPtr> items;
  std::map<std::string, JsonPtr> members;

  // Parse `text`; returns nullptr on malformed input.
  static JsonPtr Parse(const std::string& text);

  bool is_object() const { return type == kObject; }
  bool is_array() const { return type == kArray; }
  bool is_string() const { return type == kString; }

  // Object member lookup; nullptr when absent or not an object.
  JsonPtr get(const std::string& key) const {
    if (type != kObject) return nullptr;
    auto it = members.find(key);
    return it == members.end() ? nullptr : it->second;
  }

  std::string str_or(const std::string& fallback) const {
    return type == kString ? str_value : fallback;
  }
  long long int_or(long long fallback) const {
    return type == kNumber ? static_cast<long long>(num_value) : fallback;
  }
};

}  // namespace egpu

#endif  // ELASTIC_GPU_JSON_H_
